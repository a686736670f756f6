"""Exact brute-force engine with the same interface as :class:`HNSWIndex`.

Host numpy engine: the ground-truth oracle in tests, and the node engine
behind the sequential (per-query coordinated) search path.  The device
engine is ScoreScan (ann/scorescan.py over kernels/l2_topk).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ExactIndex:
    def __init__(self, data: np.ndarray, ids: Optional[np.ndarray] = None,
                 **_: object):
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.ids = (np.arange(len(data), dtype=np.int64) if ids is None
                    else np.asarray(ids, dtype=np.int64))
        self._norms = np.einsum("nd,nd->n", self.data, self.data)
        self._distance_computations = 0

    def _all_dists(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.float32)
        self._distance_computations += len(self.data)
        return self._norms - 2.0 * (self.data @ q) + float(q @ q)

    def purged(self, drop) -> "ExactIndex":
        """Copy of this index with the rows whose external id is in ``drop``
        physically removed (compaction's tombstone purge)."""
        drop = set(int(v) for v in drop)
        keep = np.fromiter((int(v) not in drop for v in self.ids),
                           bool, len(self.ids))
        return ExactIndex(self.data[keep], ids=self.ids[keep])

    def search(self, q: np.ndarray, k: int, efs: int = 0
               ) -> List[Tuple[float, np.int64]]:
        d = self._all_dists(q)
        k = min(k, len(d))
        if k == 0:
            return []
        part = np.argpartition(d, k - 1)[:k]
        order = part[np.argsort(d[part])]
        return [(float(d[i]), self.ids[i]) for i in order]

    # resumable API parity: exact search has nothing left to resume.
    def begin_search(self, q: np.ndarray, efs: int):
        d = self._all_dists(q)
        n = min(int(efs), len(d))
        part = np.argpartition(d, n - 1)[:n] if n < len(d) else np.arange(len(d))
        order = part[np.argsort(d[part])]
        res = [(float(d[i]), int(i)) for i in order]
        return res, ("exact", res)

    def resume_search(self, q: np.ndarray, state, efs: int):
        d = self._all_dists(q)
        n = min(int(efs), len(d))
        part = np.argpartition(d, n - 1)[:n] if n < len(d) else np.arange(len(d))
        order = part[np.argsort(d[part])]
        return [(float(d[i]), int(i)) for i in order]

    def __len__(self) -> int:
        return len(self.data)

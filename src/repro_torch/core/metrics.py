"""Evaluation metrics: the brute-force authorized oracle and recall@k."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def brute_force_topk(data: np.ndarray, mask: np.ndarray, x: np.ndarray,
                     k: int) -> List[Tuple[float, int]]:
    """Exact top-k over the rows ``mask`` admits (host numpy, diff form)."""
    ids = np.flatnonzero(mask)
    if not len(ids):
        return []
    diff = data[ids] - np.asarray(x, dtype=np.float32)
    d = np.einsum("nd,nd->n", diff, diff)
    m = min(k, len(d))
    part = np.argpartition(d, m - 1)[:m] if m < len(d) else np.arange(len(d))
    order = part[np.argsort(d[part])]
    return [(float(d[i]), int(ids[i])) for i in order]


def norm_scale(queries: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Per-query cancellation scale of the norm trick, ``|q|^2 + max|v|^2``:
    the magnitude float32 rounding in ``|q|^2 + |v|^2 - 2 q.v`` is relative
    to."""
    q = np.asarray(queries, np.float64)
    v = np.asarray(data, np.float64)
    vmax = float((v * v).sum(axis=1).max()) if len(v) else 0.0
    return (q * q).sum(axis=1) + vmax


def topk_agreement(dists, ids, ref_dists, ref_ids, scale,
                   rtol: float = 1e-5, rel_atol: float = 1e-5) -> dict:
    """Hold a ``(B, k)`` top-k result to a reference under the parity rule.

    * distances are ``allclose`` with ``rtol`` and ``atol = rel_atol *
      scale`` per query (``scale`` from :func:`norm_scale`); empty slots
      must be +inf on both sides;
    * ids are equal at every position, except where the two distances there
      agree within that tolerance — a near-tie swap, where a different
      summation order reordered vectors a few ULPs apart.  A swap is a run
      of consecutive differing positions; at most one per query.

    Returns ``{"ok", "swaps" (per-query counts), "far" (positions whose
    distances disagree), "max_abs_err" (over finite pairs)}``.
    """
    d = np.asarray(dists, np.float64)
    r = np.asarray(ref_dists, np.float64)
    i = np.asarray(ids, np.int64)
    ri = np.asarray(ref_ids, np.int64)
    atol = rel_atol * np.asarray(scale, np.float64).reshape(-1, 1)
    both_inf = np.isinf(d) & np.isinf(r)
    with np.errstate(invalid="ignore"):
        err = np.where(both_inf, 0.0, np.abs(d - r))
    close = both_inf | (err <= atol + rtol * np.abs(np.where(both_inf, 0, r)))
    differ = i != ri
    starts = differ & ~np.concatenate(
        [np.zeros((len(i), 1), bool), differ[:, :-1]], axis=1)
    swaps = starts.sum(axis=1)
    finite = np.isfinite(d) & np.isfinite(r)
    return {"ok": bool(close.all() and (swaps <= 1).all()),
            "swaps": swaps,
            "far": int((~close).sum()),
            "max_abs_err": float(err[finite].max()) if finite.any() else 0.0}


def recall_at_k(result_ids: Sequence[int], truth_ids: Sequence[int],
                k: int) -> float:
    truth = set(list(truth_ids)[:k])
    if not truth:
        return 1.0
    got = set(list(result_ids)[:k])
    return len(got & truth) / len(truth)

"""ScoreScan — the device retrieval engine (DESIGN.md §3).

Each lattice node's vectors are packed densely and stay resident on the
device; queries are scored by the ``l2_topk`` kernel (distances +
in-kernel authorization words + coordinated-search bound, one launch per
query batch).  Node-level pruning replaces HNSW's beam bound: every node
stores its centroid ``c`` and radius ``rho``; for a query ``q`` the
triangle inequality gives ``dist(q, v) >= (|q-c| - rho)^2`` for all
members, so a node whose lower bound exceeds the k-th distance so far is
skipped without touching device memory.

Resident per index, uploaded once at construction: the centroid-centered
rows, their ``|v|^2``, the auth words as ``(W, n)``, the attribute words as
``(P, n)`` and the external ids.  Per call only the queries, role rows,
bounds and require/forbid rows cross to the device, and the ``(B, k)``
result comes back — one host synchronisation per launch, since the merge
of results across nodes runs on the host (core/batched.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.l2_topk import L2TopKConfig, l2_topk_words


def _word_plane(words: np.ndarray, n: int, device) -> torch.Tensor:
    """``(n,)`` / ``(n, W)`` uint32 words as a word-major ``(W, n)`` int32
    tensor with the same bits."""
    w = np.asarray(words, np.uint32).reshape(n, -1)
    return torch.from_numpy(
        np.ascontiguousarray(w.T).view(np.int32)).to(device)


def _query_words(rows, b: int, width: int, device) -> torch.Tensor:
    """Per-query uint32 word rows (``(B,)`` single-word or ``(B, W)``) as a
    ``(B, W)`` int32 tensor on ``device``."""
    arr = np.ascontiguousarray(
        np.asarray(rows, np.uint32).reshape(b, width)).view(np.int32)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass
class ScoreScanIndex:
    """Engine-compatible dense scan index over one lattice node.

    ``auth_bits`` is the per-vector authorization mask: ``(n,)`` uint32 for
    role universes up to 32 roles or ``(n, W)`` packed uint32 words for
    wider universes (W = ceil(n_roles/32), DESIGN.md §Role Masks).
    Role-mask operands to the search methods carry the matching width: a
    scalar / ``(B,)`` for single-word indexes, a ``(W,)`` / ``(B, W)`` word
    array otherwise.  ``data``, ``ids``, ``auth_bits`` and ``attr_bits``
    stay on the host as the engine interface's numpy view; the kernel
    reads the copies resident on ``device`` (``None`` → ``cuda``).
    """

    data: np.ndarray                 # (n, d) float32
    ids: np.ndarray                  # (n,) int64 external ids
    auth_bits: np.ndarray            # (n,) or (n, W) uint32 role mask words
    attr_bits: Optional[np.ndarray] = None   # (n, P) uint32 predicate words
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.data = np.ascontiguousarray(self.data, dtype=np.float32)
        self.ids = np.asarray(self.ids, dtype=np.int64)
        self.auth_bits = np.ascontiguousarray(self.auth_bits,
                                              dtype=np.uint32)
        if self.attr_bits is not None:
            self.attr_bits = np.ascontiguousarray(self.attr_bits,
                                                  dtype=np.uint32)
            if self.attr_bits.ndim == 1:
                self.attr_bits = self.attr_bits[:, None]
        n = len(self.data)
        self.centroid = self.data.mean(axis=0) if n else None
        if self.centroid is not None:
            d = self.data - self.centroid
            self.radius = float(np.sqrt((d * d).sum(axis=1).max()))
            # node-centered vectors: the ||q||^2+||v||^2-2qv norm trick
            # cancels catastrophically when magnitudes dwarf distances;
            # distances are translation-invariant, so centering at the node
            # centroid keeps the kernel's f32 math well-conditioned.
            centered = np.ascontiguousarray(d, dtype=np.float32)
        else:
            self.radius = 0.0
            centered = self.data
        dev = self.device
        self._db = torch.from_numpy(centered).to(dev)
        self._db_norms = torch.sum(self._db * self._db, dim=1)
        self._auth = _word_plane(self.auth_bits, n, dev)
        self._attr = (None if self.attr_bits is None
                      else _word_plane(self.attr_bits, n, dev))
        self._ids = torch.from_numpy(self.ids).to(dev)
        self._distance_computations = 0

    def __len__(self) -> int:
        return len(self.data)

    @property
    def mask_width(self) -> int:
        """Auth-mask width in packed uint32 words (1 = single-word path)."""
        return 1 if self.auth_bits.ndim == 1 else self.auth_bits.shape[1]

    def _full_mask(self):
        """Role mask admitting every vector (engine-interface parity)."""
        if self.mask_width == 1:
            return np.uint32(0xFFFFFFFF)
        return np.full(self.mask_width, 0xFFFFFFFF, np.uint32)

    # ---------------------------------------------------------------- bounds
    def lower_bound(self, q: np.ndarray) -> float:
        """min possible squared distance from q to any member (triangle)."""
        if self.centroid is None:
            return float("inf")
        dc = float(np.linalg.norm(q - self.centroid))
        return max(0.0, dc - self.radius) ** 2

    def lower_bounds(self, qs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`lower_bound` over a (B, d) query batch."""
        if self.centroid is None:
            return np.full(len(qs), np.inf, dtype=np.float32)
        dc = np.linalg.norm(qs - self.centroid, axis=1)
        return np.maximum(0.0, dc - self.radius) ** 2

    # ---------------------------------------------------------------- search
    def _pred_kwargs(self, require, forbid, b: int):
        """Kernel predicate operands for a require/forbid pair; empty when no
        predicate is active (the P=0 kernel path)."""
        if require is None and forbid is None:
            return {}
        if self._attr is None:
            raise ValueError(
                "predicate filter on an index with no attr_bits plane")
        p = self._attr.shape[0]
        zeros = np.zeros((b, p), np.uint32)
        return dict(
            attr_words=self._attr,
            require=_query_words(zeros if require is None else require,
                                 b, p, self.device),
            forbid=_query_words(zeros if forbid is None else forbid,
                                b, p, self.device))

    def search_masked(self, q: np.ndarray, k: int, role_mask,
                      bound: Optional[float] = None,
                      require=None, forbid=None
                      ) -> List[Tuple[float, int]]:
        """Exact authorized top-k of one query; ids are external.

        ``role_mask`` is a uint32 scalar (single-word indexes) or a ``(W,)``
        word array matching :attr:`mask_width`.  ``require``/``forbid`` are
        optional ``(P,)`` predicate word rows evaluated in the same launch.
        """
        if not len(self.data):
            return []
        d, ext = self.search_masked_batch(
            np.asarray(q, np.float32)[None, :], k,
            np.asarray(role_mask, np.uint32)[None],
            bounds=None if bound is None else np.asarray([bound], np.float32),
            require=None if require is None
            else np.asarray(require, np.uint32)[None],
            forbid=None if forbid is None
            else np.asarray(forbid, np.uint32)[None])
        keep = ext[0] >= 0
        return [(float(dd), int(ii))
                for dd, ii in zip(d[0][keep], ext[0][keep])]

    def search_masked_batch(self, qs: np.ndarray, k: int,
                            role_masks: np.ndarray,
                            bounds: Optional[np.ndarray] = None,
                            require=None, forbid=None
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched :meth:`search_masked`: one kernel launch for B queries.

        Args:
          qs: (B, d) float32 query batch.
          role_masks: (B,) uint32 per-query role bitmask, or (B, W) packed
            word rows for multi-word indexes (:attr:`mask_width`).
          bounds: optional (B,) float32 per-query coordinated-search bound.
          require: optional (B, P) per-query required-predicate word rows.
          forbid: optional (B, P) per-query forbidden-predicate word rows.

        Returns:
          (dists (B, k) float32, external ids (B, k) int64) numpy arrays;
          empty slots are +inf / -1.
        """
        b = len(qs)
        if not len(self.data):
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        self._distance_computations += len(self.data) * b
        d, i = l2_topk_words(k=k, **self.kernel_operands(
            qs, role_masks, bounds=bounds, require=require, forbid=forbid))
        # local row ids -> external ids on the device; the distances ride
        # back bit for bit beside them, so one synchronising copy brings both
        ext = torch.where(i >= 0, self._ids[i.clamp(min=0).long()], -1)
        both = torch.stack((ext, d.view(torch.int32).long())).cpu().numpy()
        return both[1].astype(np.int32).view(np.float32), both[0]

    def kernel_operands(self, qs: np.ndarray, role_masks,
                        bounds: Optional[np.ndarray] = None,
                        require=None, forbid=None) -> dict:
        """The ``l2_topk_words`` operands of a :meth:`search_masked_batch`
        call (all but ``k``): the batch's centered queries, role rows,
        bounds and predicate rows, uploaded, beside the resident rows,
        norms, auth words and attribute words."""
        b = len(qs)
        dev = self.device
        qc = (np.asarray(qs, np.float32) - self.centroid).astype(np.float32)
        bnd = (np.full(b, np.inf, np.float32) if bounds is None
               else np.asarray(bounds, np.float32).reshape(b))
        return dict(
            queries=torch.from_numpy(np.ascontiguousarray(qc)).to(dev),
            db=self._db, db_norms=self._db_norms, auth_words=self._auth,
            role_rows=_query_words(role_masks, b, self.mask_width, dev),
            bounds=torch.from_numpy(np.ascontiguousarray(bnd)).to(dev),
            **self._pred_kwargs(require, forbid, b))

    # engine-interface parity (used when plugged into the generic store)
    def search(self, q: np.ndarray, k: int, efs: int = 0):
        return self.search_masked(q, k, role_mask=self._full_mask())

    def begin_search(self, q: np.ndarray, efs: int):
        res = self.search_masked(q, max(efs, 1), role_mask=self._full_mask())
        internal = {int(e): j for j, e in enumerate(self.ids)}
        out = [(dd, internal[vid]) for dd, vid in res]
        return out, ("scorescan", out)

    def resume_search(self, q: np.ndarray, state, efs: int):
        res = self.search_masked(q, max(efs, 1), role_mask=self._full_mask())
        internal = {int(e): j for j, e in enumerate(self.ids)}
        return [(dd, internal[vid]) for dd, vid in res]


def policy_auth_words(policy) -> np.ndarray:
    """Per-vector in-kernel auth mask for a policy: ``(n,)`` uint32 when the
    role universe fits one word, else ``(n, W)`` packed words (DESIGN.md
    §Role Masks).  Exact at any width — no role aliasing."""
    words = policy.role_words()                       # (n, W) uint32, exact
    return words[:, 0] if words.shape[1] == 1 else words


def pack_leftover_shard(leftover_vectors, leftover_ids, policy,
                        attr_words: Optional[np.ndarray] = None,
                        device: DeviceLike = None
                        ) -> Optional[ScoreScanIndex]:
    """Concatenate every leftover block into one auth-masked ScoreScan shard.

    Leftover blocks are individually tiny (below the lam scan threshold).
    Packing them into a single :class:`ScoreScanIndex` whose per-vector
    ``auth_bits`` carry each block's role combination lets a whole
    micro-batch's leftover phase ride **one** ``l2_topk`` launch: each query
    row filters by its own role mask in-kernel (DESIGN.md §Continuous
    Batching).  Returns ``None`` when there are no leftover vectors.
    """
    blocks = [b for b in sorted(leftover_ids) if len(leftover_ids[b])]
    if not blocks:
        return None
    data = np.concatenate([leftover_vectors[b] for b in blocks])
    ids = np.concatenate([leftover_ids[b] for b in blocks])
    bits = policy_auth_words(policy)
    return ScoreScanIndex(data=data, ids=ids, auth_bits=bits[ids],
                          attr_bits=None if attr_words is None
                          else np.asarray(attr_words, np.uint32)[ids],
                          device=device)


def scorescan_factory(policy, config: Optional[L2TopKConfig] = None,
                      attr_words: Optional[np.ndarray] = None,
                      device: DeviceLike = None):
    """Engine factory wiring the per-vector auth mask words from the policy
    (single-word up to 32 roles, multi-word beyond) and, when the store
    carries a predicate plane, the (N, P) attribute words.  Engines live on
    ``device`` (``None`` → ``cuda``, which raises without a card).
    ``config`` keeps the reference's signature; :class:`L2TopKConfig` has
    no fields."""
    dev = resolve_device(device)
    bits = policy_auth_words(policy)
    attrs = None if attr_words is None else np.asarray(attr_words, np.uint32)

    def make(data: np.ndarray, ids: np.ndarray) -> ScoreScanIndex:
        return ScoreScanIndex(data=data, ids=ids,
                              auth_bits=bits[ids],
                              attr_bits=None if attrs is None else attrs[ids],
                              device=dev)
    return make


def coordinated_scan_search(store, q: np.ndarray, role: int, k: int,
                            stats=None) -> List[Tuple[float, int]]:
    """Coordinated search specialised for ScoreScan engines, one query.

    Pure nodes first (tightens the k-th bound), then impure / distant nodes
    in ascending lower-bound order; a node is skipped entirely when its
    centroid-radius lower bound exceeds the current bound (DESIGN.md §3).
    """
    from ..core.coordinated import SearchStats, _TopK, _scan_leftovers

    stats = stats if stats is not None else SearchStats()
    q = np.asarray(q, dtype=np.float32)
    plan = store.plans[role]
    mask = store.authorized_mask(role)
    role_mask = store.kernel_role_mask((role,))
    rs = _TopK(k)
    _scan_leftovers(store, plan, q, rs, stats)
    pure, impure = [], []
    for key in plan.nodes:
        eng = store.engines.get(key)
        if eng is None:
            continue
        (pure if store.is_pure(key, mask) else impure).append((key, eng))
    stats.indices_visited += len(pure) + len(impure)
    for key, eng in sorted(pure, key=lambda t: t[1].lower_bound(q)):
        stats.data_touched += len(eng)
        stats.data_authorized_touched += len(eng)
        if eng.lower_bound(q) > rs.kth_dist():
            stats.phase2_skipped += 1
            stats.impure_visits += 1   # counted as a bound-skip opportunity
            continue
        for dd, vid in eng.search_masked(q, k, role_mask,
                                         bound=rs.kth_dist()):
            rs.push(dd, vid)
    for key, eng in sorted(impure, key=lambda t: t[1].lower_bound(q)):
        total, auth = store.node_total_and_auth(key, mask)
        stats.impure_visits += 1
        stats.data_touched += total
        stats.data_authorized_touched += auth
        if eng.lower_bound(q) > rs.kth_dist():
            stats.phase2_skipped += 1
            continue
        for dd, vid in eng.search_masked(q, k, role_mask,
                                         bound=rs.kth_dist()):
            if mask[vid]:
                rs.push(dd, vid)
    return rs.items()

"""Coordinated top-k execution across a role's plan (paper §6.2, Alg. 7/16/17).

Order of operations (Algorithm 7):
  1. linear-scan leftovers → seed the global top-k heap RS,
  2. pure indices: standard HNSW top-k, merge (all results authorized),
  3. impure indices: *uninflated* probe first; if the local unfiltered k-th
     distance already exceeds the global k-th authorized distance, phase 2 is
     skipped (the HNSW search-accuracy assumption says nothing unseen there
     can improve RS); otherwise resume the base-layer beam with efs inflated
     by the impurity factor lambda (Eq. 1) and merge authorized survivors.

This is the per-query algorithm; the serving entry point is
``VectorStore.search(queries)`` (core/store.py), which falls back to
:func:`coordinated_search` whenever a store's engines cannot take the
batched path.  :class:`SearchStats` lives in core/api.py and is re-exported
here.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .api import SearchStats
from .costmodel import CostModel
from .policy import Role
from .queryplan import Plan
from .store import VectorStore


class _TopK:
    """Bounded max-heap over (dist, id): keeps the k smallest distances."""

    def __init__(self, k: int):
        self.k = k
        self._h: List[Tuple[float, int]] = []   # (-dist, id)
        self._seen: set = set()

    def push(self, dist: float, vid: int) -> None:
        if vid in self._seen:
            return
        if len(self._h) < self.k:
            heapq.heappush(self._h, (-dist, vid))
            self._seen.add(vid)
        elif dist < -self._h[0][0]:
            _, old = heapq.heapreplace(self._h, (-dist, vid))
            self._seen.discard(old)
            self._seen.add(vid)

    def kth_dist(self) -> float:
        if len(self._h) < self.k:
            return float("inf")
        return -self._h[0][0]

    def items(self) -> List[Tuple[float, int]]:
        return sorted([(-d, i) for d, i in self._h])


def _scan_leftovers(store: VectorStore, plan: Plan, x: np.ndarray,
                    rs: _TopK, stats: SearchStats,
                    pred_mask: Optional[np.ndarray] = None) -> None:
    for b in plan.leftover_blocks:
        vecs = store.leftover_vectors.get(b)
        if vecs is None or not len(vecs):
            continue
        ids = store.leftover_ids[b]
        diff = vecs - x
        d = np.einsum("nd,nd->n", diff, diff)
        if pred_mask is not None:
            d = np.where(pred_mask[ids], d, np.inf)
        stats.leftover_vectors_scanned += len(vecs)
        stats.data_touched += len(vecs)
        stats.data_authorized_touched += len(vecs)
        m = min(rs.k, len(d))
        part = np.argpartition(d, m - 1)[:m] if m < len(d) else np.arange(len(d))
        for i in part:
            if np.isfinite(d[i]):
                rs.push(float(d[i]), int(ids[i]))


def _split_plan(store: VectorStore, plan: Plan, mask: np.ndarray):
    pure, impure = [], []
    for key in plan.nodes:
        if key not in store.engines:
            continue
        (pure if store.is_pure(key, mask) else impure).append(key)
    return pure, impure


def coordinated_search(store: VectorStore, x: np.ndarray, role: Role, k: int,
                       efs: int, stats: Optional[SearchStats] = None,
                       roles: Optional[Sequence[Role]] = None,
                       where=None) -> List[Tuple[float, int]]:
    """Algorithm 7. ``roles`` switches to multi-role union semantics.

    ``where`` (a tuple of predicate atoms, see :class:`..api.Query`) narrows
    results to rows whose attribute words satisfy the conjunction; nodes are
    then routed per the selectivity-aware cost model — an exact filtered scan
    when beam traversal inflated by 1/selectivity would cost more, a
    post-filtered over-fetching beam otherwise.
    """
    stats = stats if stats is not None else SearchStats()
    x = np.asarray(x, dtype=np.float32)
    if roles is None:
        roles = [role]
        mask = store.authorized_mask(role)
        plan = store.plans[role]
    else:
        mask = store.authorized_mask_multi(roles)
        plan = _union_plan(store, roles)
    if where:
        return _filtered_plan_search(store, plan, mask, x, k, efs, where,
                                     stats)
    rs = _TopK(k)
    _scan_leftovers(store, plan, x, rs, stats)
    pure, impure = _split_plan(store, plan, mask)
    stats.indices_visited += len(pure) + len(impure)
    # ---- pure indices ------------------------------------------------------
    for key in pure:
        eng = store.engines[key]
        stats.data_touched += len(eng)
        stats.data_authorized_touched += len(eng)
        for d, vid in eng.search(x, k, efs):
            rs.push(float(d), int(vid))
    # ---- impure indices (bound-pruned, resumable) --------------------------
    for key in impure:
        eng = store.engines[key]
        total, auth = store.node_total_and_auth(key, mask)
        stats.data_touched += total
        stats.data_authorized_touched += auth
        lam = math.ceil(total / max(auth, 1))
        stats.impure_visits += 1
        stats.efs_worst_case += min(lam * efs, total)
        local, state = eng.begin_search(x, efs)
        stats.efs_used += min(efs, total)
        for d, internal in local:
            vid = int(eng.ids[internal])
            if mask[vid]:
                rs.push(float(d), vid)
        if len(local) >= k and rs.kth_dist() <= local[k - 1][0]:
            stats.phase2_skipped += 1          # global bound dominates: stop
            continue
        inflated = min(int(lam * efs), total)
        if inflated > efs:
            resumed = eng.resume_search(x, state, inflated)
            stats.efs_used += inflated - efs
            for d, internal in resumed:
                if d > rs.kth_dist():
                    break
                vid = int(eng.ids[internal])
                if mask[vid]:
                    rs.push(float(d), vid)
    return rs.items()


def _filtered_plan_search(store: VectorStore, plan: Plan, mask: np.ndarray,
                          x: np.ndarray, k: int, efs: int, where,
                          stats: SearchStats) -> List[Tuple[float, int]]:
    """Plan execution under a predicate conjunction (hybrid filtered search).

    Each plan node is routed independently: when the selectivity-aware cost
    model says a 1/sel-inflated beam costs at least as much as scanning the
    node (or routing is enabled and the node sits under ``lam_threshold``),
    the node is scanned exactly over its pinned rows; otherwise the node's
    beam over-fetches ceil(k/sel) candidates and survivors are post-filtered.
    Leftover blocks are always scanned exactly (they are scans already).
    """
    require, forbid = store.compile_where(where)
    pred_mask = store.predicate_mask(require, forbid)
    sel = store.where_selectivity(where)
    cm = store.cost_model if store.cost_model is not None else CostModel()
    rs = _TopK(k)
    _scan_leftovers(store, plan, x, rs, stats, pred_mask=pred_mask)
    pure, impure = _split_plan(store, plan, mask)
    stats.indices_visited += len(pure) + len(impure)
    node_iter = [(key, None) for key in pure] + [(key, mask) for key in impure]
    for key, node_mask in node_iter:
        eng = store.engines[key]
        if node_mask is None:
            total = auth = len(eng)
        else:
            total, auth = store.node_total_and_auth(key, mask)
            stats.impure_visits += 1
        stats.data_touched += total
        stats.data_authorized_touched += auth
        beam_cost = cm.role_query_cost(total, auth, k, selectivity=sel)
        if store.route_by_selectivity and beam_cost >= cm.scan_cost(total):
            _exact_filtered_node(eng, x, node_mask, pred_mask, rs)
            continue
        lam = math.ceil(total / max(auth, 1))
        kk = min(total, int(math.ceil(k / max(sel, 1e-9))))
        effs = min(int(math.ceil(lam * max(efs, k) / max(sel, 1e-9))), total)
        stats.efs_worst_case += effs
        stats.efs_used += effs
        for d, vid in eng.search(x, max(kk, k), max(effs, efs)):
            vid = int(vid)
            if pred_mask[vid] and (node_mask is None or node_mask[vid]):
                rs.push(float(d), vid)
    return rs.items()


def _exact_filtered_node(eng, x: np.ndarray, node_mask: Optional[np.ndarray],
                         pred_mask: np.ndarray, rs: _TopK) -> None:
    """Exact (authorized AND predicate) scan over one node's pinned rows."""
    ids = np.asarray(eng.ids, dtype=np.int64)
    if not len(ids):
        return
    data = np.asarray(eng.data, dtype=np.float32)
    diff = data - x
    d = np.einsum("nd,nd->n", diff, diff)
    ok = pred_mask[ids]
    if node_mask is not None:
        ok = ok & node_mask[ids]
    d = np.where(ok, d, np.inf)
    m = min(rs.k, len(d))
    part = np.argpartition(d, m - 1)[:m] if m < len(d) else np.arange(len(d))
    for i in part:
        if np.isfinite(d[i]):
            rs.push(float(d[i]), int(ids[i]))


def _union_plan(store: VectorStore, roles: Sequence[Role]) -> Plan:
    """Multi-role plan cover; the implementation (node/leftover dedup with
    node-covered leftovers dropped) lives on the store and is cached there."""
    return store.plan_for_roles(tuple(int(r) for r in roles))

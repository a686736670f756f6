"""EffVEDA — the efficient bottom-up solution (paper §5, Alg. 4/5/6/12/13).

Phase 1 traverses the exclusive lattice bottom-up (broadest role sets first)
and copies each child's *entire contents* into a **valid partition** of its
ancestors (disjoint role sets covering tau) so every node stays pure towards
its original role set (Thm 5.2); the source is then deleted.  A degenerate
single-ancestor copy (source kept) is admitted with matching storage cost.
Phase 2 greedily merges sub-threshold nodes with the best relative (ancestor /
descendant / sibling) until indexable; merges add no storage but may add
impurity.  Finalization is shared with VEDA (Alg. 11).
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from .costmodel import HNSWCostModel
from .lattice import Lattice, NodeKey
from .policy import AccessPolicy, Role, RoleSet
from .queryplan import Plan, build_all_plans
from .veda import BuildResult, VedaBuilder


class EffVedaBuilder(VedaBuilder):
    """Shares finalization/result plumbing with VEDA; replaces both phases."""

    def __init__(self, policy: AccessPolicy, cost_model: HNSWCostModel,
                 beta: float = 1.1, k: int = 10, max_eta: int = 2, **kw):
        super().__init__(policy, cost_model, beta=beta, k=k, **kw)
        self.max_eta = max(2, int(max_eta))

    # ------------------------------------------------------------ Phase 1
    def _copy_gain(self, lat: Lattice, ck: NodeKey, ak: NodeKey) -> float:
        """Delta_c (Def. 5.3): per-role gain of folding child into ancestor.

        Both nodes are pure for their role sets during Phase 1, so the gain is
        Cost(child) + Cost(ancestor) - Cost(child ∪ ancestor), evaluated as
        pure visits (the merged node stays pure for the ancestor's roles).
        """
        nc = lat.node_size(ck)
        na = lat.node_size(ak)
        union = lat.nodes[ck].blocks | lat.nodes[ak].blocks
        nu = int(sum(int(lat.block_sizes[b]) for b in union))
        k = self.k
        cm = self.cm
        return (cm.role_query_cost(nc, nc, k) + cm.role_query_cost(na, na, k)
                - cm.role_query_cost(nu, nu, k))

    def _find_best_partition(self, lat: Lattice, ck: NodeKey,
                             ancestors: List[NodeKey], buf: int
                             ) -> Tuple[Optional[List[NodeKey]], float]:
        """Algorithm 5/13: best valid partition with eta<=max_eta, plus the
        degenerate single-ancestor copy (source kept)."""
        tau = lat.nodes[ck].roles
        by_roles: Dict[RoleSet, NodeKey] = {lat.nodes[a].roles: a
                                            for a in ancestors}
        best: Optional[List[NodeKey]] = None
        best_f = 0.0
        child_sz = max(lat.node_size(ck), 1)
        # eta = 2 exact-complement scan + degenerate single-ancestor option
        for ak in ancestors:
            tp = lat.nodes[ak].roles
            gain = len(tp) * self._copy_gain(lat, ck, ak)
            comp = frozenset(tau - tp)
            if comp and comp in by_roles:
                ak2 = by_roles[comp]
                f = (gain + len(comp) * self._copy_gain(lat, ck, ak2)) / child_sz
                if f > best_f:
                    best, best_f = [ak, ak2], f
            # degenerate: single ancestor, keep the source (same +1 copy cost)
            f = gain / child_sz
            if f > best_f:
                best, best_f = [ak], f
        # larger partitions (Algorithm 12), enumerated in increasing eta
        if best is None and self.max_eta > 2:
            for eta in range(3, min(self.max_eta, len(ancestors), len(tau)) + 1):
                if eta * child_sz > buf:
                    break
                for combo in itertools.combinations(ancestors, eta):
                    rsets = [lat.nodes[a].roles for a in combo]
                    if sum(len(s) for s in rsets) != len(tau):
                        continue
                    if frozenset().union(*rsets) != tau:
                        continue
                    f = sum(len(lat.nodes[a].roles) *
                            self._copy_gain(lat, ck, a)
                            for a in combo) / (child_sz * (eta - 1))
                    if f > best_f:
                        best, best_f = list(combo), f
                if best is not None:
                    break
        return best, best_f

    def _copy_phase_eff(self, lat: Lattice, buf: int) -> int:
        layers = lat.layers()
        applied = 0
        for depth in sorted(layers, reverse=True):   # bottom-up: broad → strict
            if depth <= 1:
                break  # top layer(s): singleton role sets have no ancestors
            bps: List[Tuple[float, NodeKey, List[NodeKey]]] = []
            for ck in layers[depth]:
                if ck not in lat.nodes:
                    continue
                ancestors = lat.ancestors(ck)
                if len(ancestors) < 1:
                    continue
                child_sz = lat.node_size(ck)
                if child_sz > buf:
                    continue
                bp, f = self._find_best_partition(lat, ck, ancestors, buf)
                if bp:
                    bps.append((f, ck, bp))
            bps.sort(key=lambda t: -t[0])
            for f, ck, bp in bps:
                if ck not in lat.nodes:
                    continue
                child_sz = lat.node_size(ck)
                # full valid partition: |bp| copies, source deleted → net
                # storage increase (|bp| - 1) * child. degenerate single copy:
                # 1 copy, source kept → +1 * child. Both charge child per copy
                # minus dedup of blocks already present.
                tau = lat.nodes[ck].roles
                covered = frozenset().union(*(lat.nodes[a].roles for a in bp))
                is_partition = (covered == tau and
                                sum(len(lat.nodes[a].roles) for a in bp)
                                == len(tau))
                n_new_copies = len(bp) - (1 if is_partition else 0)
                if n_new_copies * child_sz > buf:
                    continue
                delta = 0
                for ak in bp:
                    delta += lat.copy_blocks(ck, ak)
                if is_partition:
                    delta -= child_sz          # source removed
                    lat.delete(ck)
                buf -= delta
                applied += 1
                self.stats["copies"] += 1
        return applied

    # ------------------------------------------------------------ Phase 2
    def _merge_benefit_eff(self, lat: Lattice, xk: NodeKey, yk: NodeKey
                           ) -> float:
        """Role-wise pure costs before minus merged cost after, including the
        impurity penalty for roles authorized for only part of the merged
        node (paper §5.2)."""
        cm, k = self.cm, self.k
        x, y = lat.nodes[xk], lat.nodes[yk]
        nx, ny = lat.node_size(xk), lat.node_size(yk)
        union = x.blocks | y.blocks
        nu = int(sum(int(lat.block_sizes[b]) for b in union))
        gain = 0.0
        for r in (x.roles | y.roles):
            before = 0.0
            if r in x.roles:
                before += cm.role_query_cost(
                    nx, x.authorized_size(self.policy, r, lat.block_sizes), k)
            if r in y.roles:
                before += cm.role_query_cost(
                    ny, y.authorized_size(self.policy, r, lat.block_sizes), k)
            auth_u = int(sum(int(lat.block_sizes[b]) for b in union
                             if r in self.policy.block_roles[b]))
            after = cm.role_query_cost(nu, auth_u, k)
            gain += before - after
        return gain / max(len(x.roles | y.roles), 1)

    def _relatives(self, lat: Lattice, key: NodeKey) -> List[NodeKey]:
        rel = lat.ancestors(key) + lat.descendants(key) + lat.siblings(key)
        return rel

    def _merge_phase_eff(self, lat: Lattice) -> int:
        lam = self.cm.lam_threshold
        applied = 0
        order = sorted(lat.nodes, key=lambda k: -lat.node_size(k))
        for key in order:
            cur = key
            guard = 0
            while (cur in lat.nodes and lat.node_size(cur) < lam
                   and guard < 64):
                guard += 1
                best_b, best_rel = 0.0, None
                for rk in self._relatives(lat, cur):
                    b = self._merge_benefit_eff(lat, cur, rk)
                    if b > best_b:
                        best_b, best_rel = b, rk
                if best_rel is None:
                    break
                # descendants merge upward into cur; otherwise cur merges into
                # the relative (paper §5.2 greedy execution)
                if lat.nodes[best_rel].roles > lat.nodes[cur].roles:
                    cur = lat.merge_into(best_rel, cur)
                else:
                    cur = lat.merge_into(cur, best_rel)
                applied += 1
                self.stats["merges"] += 1
        return applied

    # ------------------------------------------------------------------ build
    def build(self) -> BuildResult:
        lat = self.lat_ex.clone()
        total = self.policy.n_vectors
        buf = int((self.beta - 1.0) * total)
        if buf > 0:
            self._copy_phase_eff(lat, buf)
        self._merge_phase_eff(lat)
        self.stats["rounds"] = 1
        leftovers = self._split_small_nodes(lat)
        plans = build_all_plans(lat, self.cm, self.k,
                                leftovers=frozenset(leftovers))
        stored = lat.total_stored() + sum(int(lat.block_sizes[b])
                                          for b in leftovers)
        buf = int(self.beta * total) - stored
        if buf > 0:
            buf = self._handle_super_impure(lat, plans, leftovers, buf)
        return BuildResult(lattice=lat, leftovers=frozenset(leftovers),
                           plans=plans, stats=dict(self.stats))


def build_effveda(policy: AccessPolicy, cost_model: HNSWCostModel,
                  beta: float = 1.1, k: int = 10, **kw) -> BuildResult:
    return EffVedaBuilder(policy, cost_model, beta=beta, k=k, **kw).build()

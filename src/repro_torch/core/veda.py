"""VEDA — the adaptive lattice-optimization algorithm (paper §4, Alg. 1–3, 11).

Greedily applies the copy/merge operation with the highest query-cost
reduction per unit of added storage (benefit function, Eq. 3) under the SA
budget beta, then finalizes: small nodes become leftovers, reclaimed budget
materializes the pure parts of super-impure nodes (Alg. 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from .costmodel import HNSWCostModel
from .lattice import Lattice, Node, NodeKey
from .policy import AccessPolicy, Role, RoleSet
from .queryplan import Plan, build_all_plans, greedy_plan, plan_cost, avg_cost


@dataclasses.dataclass
class BuildResult:
    """Output of VEDA/EffVEDA: optimized lattice + leftovers + plans + stats."""

    lattice: Lattice
    leftovers: FrozenSet[int]            # exclusive block ids for linear scan
    plans: Dict[Role, Plan]
    stats: Dict[str, float]

    @property
    def sa(self) -> float:
        stored = self.lattice.total_stored()
        stored += sum(int(self.lattice.block_sizes[b]) for b in self.leftovers)
        return stored / max(1, self.lattice.policy.n_vectors)

    def indexed_vectors(self) -> int:
        return self.lattice.total_stored()

    def leftover_vectors(self) -> int:
        return int(sum(int(self.lattice.block_sizes[b]) for b in self.leftovers))


class VedaBuilder:
    """Implements Algorithm 1 (overview) with Algorithms 2/3/11 as phases."""

    def __init__(self, policy: AccessPolicy, cost_model: HNSWCostModel,
                 beta: float = 1.1, k: int = 10,
                 role_weights: Optional[Dict[Role, float]] = None,
                 max_rounds: int = 8):
        self.policy = policy
        self.cm = cost_model
        self.beta = float(beta)
        self.k = int(k)
        self.weights = role_weights
        self.max_rounds = max_rounds
        self.lat_ex = Lattice.exclusive(policy)
        self.stats: Dict[str, float] = {"copies": 0, "merges": 0,
                                        "refined": 0, "rounds": 0}

    # ----------------------------------------------------------- cost helpers
    def _role_cost(self, lat: Lattice, plans: Dict[Role, Plan],
                   r: Role) -> float:
        return plan_cost(lat, plans[r], r, self.cm, self.k)

    def _affected_roles(self, lat: Lattice, plans: Dict[Role, Plan],
                        touched: List[NodeKey],
                        block_roles: FrozenSet[Role]) -> List[Role]:
        out = set(block_roles)
        tset = set(touched)
        for r, p in plans.items():
            if tset & set(p.nodes):
                out.add(r)
        return sorted(out)

    def _delta_avgcost(self, lat: Lattice, plans: Dict[Role, Plan],
                       sim: Lattice, roles: List[Role]) -> Tuple[float, Dict[Role, Plan]]:
        """AvgCost(L) - AvgCost(L') restricted to roles whose plans change."""
        n_roles = self.policy.n_roles
        delta = 0.0
        new_plans: Dict[Role, Plan] = {}
        phi = sim.container_map()
        for r in roles:
            before = self._role_cost(lat, plans, r)
            newp = greedy_plan(sim, r, self.cm, self.k, phi=phi)
            after = plan_cost(sim, newp, r, self.cm, self.k)
            w = 1.0 / n_roles if self.weights is None else (
                self.weights.get(r, 0.0) /
                max(sum(self.weights.values()), 1e-12))
            delta += w * (before - after)
            new_plans[r] = newp
        return delta, new_plans

    # -------------------------------------------------------------- Phase 1/2
    def _candidate_pairs(self, lat: Lattice) -> List[Tuple[NodeKey, NodeKey]]:
        """Child–ancestor pairs from L_ex with both nodes still present."""
        pairs = []
        for ck, ak in self.lat_ex.child_ancestor_pairs():
            if ck in lat.nodes and ak in lat.nodes:
                pairs.append((ck, ak))
        return pairs

    def _copy_phase(self, lat: Lattice, plans: Dict[Role, Plan],
                    buf: int) -> Tuple[int, int]:
        """Algorithm 2: greedy highest-benefit copies under the budget."""
        applied = 0
        applied_ops: Set[Tuple[NodeKey, NodeKey]] = set()

        def score(ck: NodeKey, ak: NodeKey):
            ex_blocks = self.lat_ex.nodes[ck].blocks
            new = ex_blocks - lat.nodes[ak].blocks
            ds = int(sum(int(lat.block_sizes[b]) for b in new))
            sim = lat.clone()
            sim.nodes[ak].blocks |= ex_blocks
            roles = self._affected_roles(
                lat, plans, [ak, ck],
                frozenset().union(*(self.policy.block_roles[b]
                                    for b in ex_blocks)))
            d, newp = self._delta_avgcost(lat, plans, sim, roles)
            return d / (ds + 1.0), ds, newp

        while buf > 0:
            pairs = self._candidate_pairs(lat)
            if not pairs:
                break
            best = None
            for ck, ak in pairs:
                if (ck, ak) in applied_ops:
                    continue
                # a copy whose exclusive blocks are already present is a no-op
                if self.lat_ex.nodes[ck].blocks <= lat.nodes[ak].blocks:
                    continue
                f, ds, newp = score(ck, ak)
                if f >= 0 and ds <= buf:
                    if best is None or f > best[0]:
                        best = (f, ds, ck, ak, newp)
            if best is None:
                break
            f, ds, ck, ak, newp = best
            if f < 0:
                break
            lat.nodes[ak].blocks |= self.lat_ex.nodes[ck].blocks
            buf -= ds
            plans.update(newp)
            applied_ops.add((ck, ak))
            applied += 1
            self.stats["copies"] += 1
        return applied, buf

    def _merge_phase(self, lat: Lattice, plans: Dict[Role, Plan]) -> int:
        """Algorithm 3: greedy strictly-positive-benefit merges."""
        applied = 0
        while True:
            pairs = self._candidate_pairs(lat)
            # also allow merging merged nodes into ancestors: use live lattice
            live_pairs = set(pairs)
            for ck, ak in lat.child_ancestor_pairs():
                live_pairs.add((ck, ak))
            best = None
            for ck, ak in live_pairs:
                if ck not in lat.nodes or ak not in lat.nodes:
                    continue
                sim = lat.clone()
                merged_key = sim.merge_into(ck, ak)
                roles = self._affected_roles(
                    lat, plans, [ak, ck],
                    frozenset(lat.nodes[ck].roles | lat.nodes[ak].roles))
                d, newp = self._delta_avgcost(lat, plans, sim, roles)
                if d > 0 and (best is None or d > best[0]):
                    best = (d, ck, ak, newp)
            if best is None:
                break
            d, ck, ak, newp = best
            lat.merge_into(ck, ak)
            plans.update(newp)
            applied += 1
            self.stats["merges"] += 1
        return applied

    # ----------------------------------------------------------- finalization
    def _split_small_nodes(self, lat: Lattice) -> Set[int]:
        """Decompose nodes < Lambda into leftover blocks; dedup copies."""
        lam = self.cm.lam_threshold
        small = [k for k in list(lat.nodes)
                 if lat.node_size(k) < lam]
        leftover: Set[int] = set()
        for k in small:
            leftover |= lat.nodes[k].blocks
            lat.delete(k)
        # blocks still hosted by surviving (indexable) nodes need no U copy
        hosted = set()
        for node in lat.nodes.values():
            hosted |= node.blocks
        return leftover - hosted

    def _handle_super_impure(self, lat: Lattice, plans: Dict[Role, Plan],
                             leftovers: Set[int], buf: int) -> int:
        """Algorithm 11: materialize pure parts of super-impure plan nodes."""
        # Step 1: collect candidates
        ref: Dict[NodeKey, int] = {}
        for r, p in plans.items():
            for nk in p.nodes:
                ref[nk] = ref.get(nk, 0) + 1
        cands = []
        for r, p in plans.items():
            for nk in p.nodes:
                if nk not in lat.nodes:
                    continue
                node = lat.nodes[nk]
                pure_ex = {b for b in node.blocks
                           if r in self.policy.block_roles[b]}
                pure_s = sum(int(lat.block_sizes[b]) for b in pure_ex)
                total = lat.node_size(nk)
                if 0 < pure_s < total:
                    cands.append((total / pure_s, -pure_s, r, nk,
                                  frozenset(pure_ex)))
        cands.sort(key=lambda t: (-t[0], t[1]))
        copied: Set[int] = set()
        standalone: Dict[int, NodeKey] = {}
        refined = 0
        for imp, _, r, nk, pure_ex in cands:
            if nk not in lat.nodes or nk not in plans[r].nodes:
                continue
            copy_s = sum(int(lat.block_sizes[b]) for b in pure_ex - copied)
            if buf < copy_s:
                continue
            # materialize each pure block standalone: indexable blocks become
            # fresh lattice nodes, small ones leftover scan blocks (Alg. 11)
            added_nodes: List[NodeKey] = []
            added_left: Set[int] = set()
            for b in pure_ex:
                already = b in copied or b in leftovers
                if int(lat.block_sizes[b]) >= self.cm.lam_threshold:
                    if b in standalone:
                        nk2 = standalone[b]
                    else:
                        nk2 = lat.add_node(self.policy.block_roles[b], {b})
                        standalone[b] = nk2
                        if not already:
                            buf -= int(lat.block_sizes[b])
                    added_nodes.append(nk2)
                else:
                    if not already:
                        buf -= int(lat.block_sizes[b])
                    leftovers.add(b)
                    added_left.add(b)
                copied.add(b)
            new_nodes = tuple(x for x in plans[r].nodes if x != nk)
            new_nodes = new_nodes + tuple(added_nodes)
            new_left = tuple(sorted(set(plans[r].leftover_blocks) | added_left))
            plans[r] = Plan(nodes=new_nodes, leftover_blocks=new_left)
            ref[nk] -= 1
            refined += 1
            self.stats["refined"] += 1
            if ref[nk] == 0:
                buf += lat.node_size(nk)
                lat.delete(nk)
        return buf

    # ------------------------------------------------------------------ build
    def build(self) -> BuildResult:
        lat = self.lat_ex.clone()
        plans = build_all_plans(lat, self.cm, self.k)
        total = self.policy.n_vectors
        buf = int(self.beta * total) - lat.total_stored()
        first = True
        while self.stats["rounds"] < self.max_rounds:
            self.stats["rounds"] += 1
            applied_c = 0
            if buf > 0:
                applied_c, buf = self._copy_phase(lat, plans, buf)
            if not first and applied_c == 0:
                break
            applied_m = self._merge_phase(lat, plans)
            # merging frees duplicates → recompute remaining budget
            buf = int(self.beta * total) - lat.total_stored()
            first = False
            if applied_m == 0:
                break
        leftovers = self._split_small_nodes(lat)
        # re-plan against the finalized lattice + leftover pool
        plans = build_all_plans(lat, self.cm, self.k,
                                leftovers=frozenset(leftovers))
        stored = lat.total_stored() + sum(int(lat.block_sizes[b])
                                          for b in leftovers)
        buf = int(self.beta * total) - stored
        if buf > 0:
            buf = self._handle_super_impure(lat, plans, leftovers, buf)
        result = BuildResult(lattice=lat, leftovers=frozenset(leftovers),
                             plans=plans, stats=dict(self.stats))
        return result


def build_veda(policy: AccessPolicy, cost_model: HNSWCostModel,
               beta: float = 1.1, k: int = 10, **kw) -> BuildResult:
    return VedaBuilder(policy, cost_model, beta=beta, k=k, **kw).build()

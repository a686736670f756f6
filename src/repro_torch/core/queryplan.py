"""Query-plan construction (paper §6.1, Algorithms 14/15).

For each role ``r`` the plan selects a minimal-cost set of lattice nodes (and
leftover blocks) whose union covers ``D(r)``.  Blocks with a single container
are mandatory; the residual cover is solved greedily (Algorithm 15) or, for
small instances, exactly by branch-and-bound (the Algorithm 14 ILP analogue).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from .costmodel import HNSWCostModel
from .lattice import Lattice, NodeKey
from .policy import AccessPolicy, Role


@dataclasses.dataclass
class Plan:
    """Per-role plan: HNSW/scan nodes ``I(r)`` + leftover blocks ``U(r)``."""

    nodes: Tuple[NodeKey, ...]
    leftover_blocks: Tuple[int, ...] = ()

    def __iter__(self):
        return iter(self.nodes)

    def __contains__(self, key) -> bool:
        return key in self.nodes


def node_cost_for_role(lat: Lattice, key: NodeKey, r: Role,
                       cm: HNSWCostModel, k: int,
                       selectivity: float = 1.0) -> float:
    node = lat.nodes[key]
    n = node.size(lat.block_sizes)
    n_auth = node.authorized_size(lat.policy, r, lat.block_sizes)
    return cm.role_query_cost(n, n_auth, k, selectivity=selectivity)


def plan_cost(lat: Lattice, plan: Plan, r: Role, cm: HNSWCostModel,
              k: int) -> float:
    cost = sum(node_cost_for_role(lat, key, r, cm, k) for key in plan.nodes)
    leftover = sum(int(lat.block_sizes[b]) for b in plan.leftover_blocks)
    if leftover:
        cost += cm.scan_cost(leftover)
    return cost


def greedy_plan(lat: Lattice, r: Role, cm: HNSWCostModel, k: int,
                phi: Optional[Dict[int, List[NodeKey]]] = None,
                leftovers: FrozenSet[int] = frozenset(),
                exact_max_candidates: int = 0) -> Plan:
    """Cover ``L_ex[r]`` with minimum estimated cost (Algorithm 15).

    ``leftovers``: blocks available for linear scan (post-finalization).  A
    block that lives both in nodes and in the leftover pool may be covered
    either way; the greedy treats the leftover pool as one more candidate per
    block with linear-scan cost.
    """
    policy = lat.policy
    need: Set[int] = {b for b in range(policy.n_blocks)
                      if r in policy.block_roles[b]}
    if not need:
        return Plan(nodes=())
    if phi is None:
        phi = lat.container_map()

    chosen: List[NodeKey] = []
    chosen_set: Set[NodeKey] = set()
    leftover_chosen: Set[int] = set()
    # --- mandatory containers: blocks with exactly one home ---------------
    for b in sorted(need):
        homes = phi.get(b, [])
        in_left = b in leftovers
        if len(homes) + (1 if in_left else 0) == 1:
            if homes:
                if homes[0] not in chosen_set:
                    chosen.append(homes[0])
                    chosen_set.add(homes[0])
            else:
                leftover_chosen.add(b)
    covered = set(leftover_chosen)
    for key in chosen:
        covered |= (lat.nodes[key].blocks & need)
    residual = need - covered
    if not residual:
        return Plan(nodes=tuple(chosen),
                    leftover_blocks=tuple(sorted(leftover_chosen)))

    # --- candidate containers for the residual ----------------------------
    cand_keys: List[NodeKey] = sorted(
        {key for b in residual for key in phi.get(b, [])
         if key not in chosen_set},
        key=repr)
    cand_cover = {key: (lat.nodes[key].blocks & residual) for key in cand_keys}
    cand_cost = {key: node_cost_for_role(lat, key, r, cm, k)
                 for key in cand_keys}

    if exact_max_candidates and len(cand_keys) <= exact_max_candidates:
        best = _exact_residual_cover(residual, cand_keys, cand_cover,
                                     cand_cost, leftovers, lat, cm)
        if best is not None:
            sel_keys, sel_left = best
            return Plan(nodes=tuple(chosen) + tuple(sel_keys),
                        leftover_blocks=tuple(sorted(leftover_chosen | sel_left)))

    # --- greedy: best cost per newly covered vector ------------------------
    while residual:
        best_key, best_score = None, float("inf")
        for key in cand_keys:
            if key in chosen_set:
                continue
            newly = cand_cover[key] & residual
            if not newly:
                continue
            nvec = sum(int(lat.block_sizes[b]) for b in newly)
            score = cand_cost[key] / max(nvec, 1)
            if score < best_score:
                best_key, best_score = key, score
        # leftover fallback: scan the cheapest residual block directly
        left_avail = [b for b in residual if b in leftovers]
        if left_avail:
            b0 = min(left_avail, key=lambda b: int(lat.block_sizes[b]))
            sc = cm.scan_cost(int(lat.block_sizes[b0])) / max(
                int(lat.block_sizes[b0]), 1)
            if sc < best_score or best_key is None:
                leftover_chosen.add(b0)
                residual.discard(b0)
                continue
        if best_key is None:
            missing = sorted(residual)
            raise ValueError(
                f"role {r}: residual blocks {missing} have no container")
        chosen.append(best_key)
        chosen_set.add(best_key)
        residual -= cand_cover[best_key]
    return Plan(nodes=tuple(chosen),
                leftover_blocks=tuple(sorted(leftover_chosen)))


def _exact_residual_cover(residual, cand_keys, cand_cover, cand_cost,
                          leftovers, lat, cm):
    """Small-instance exact residual cover (Algorithm 14 analogue)."""
    best_cost, best = float("inf"), None
    left_avail = residual & set(leftovers)
    for rsz in range(len(cand_keys) + 1):
        for combo in itertools.combinations(cand_keys, rsz):
            cov = set().union(*(cand_cover[c] for c in combo)) if combo else set()
            rest = residual - cov
            if rest - left_avail:
                continue
            cost = sum(cand_cost[c] for c in combo)
            cost += cm.scan_cost(sum(int(lat.block_sizes[b]) for b in rest))
            if cost < best_cost:
                best_cost, best = cost, (list(combo), set(rest))
        if best is not None and rsz >= 2:
            break  # plans rarely improve past tiny covers; bound the search
    return best


def build_all_plans(lat: Lattice, cm: HNSWCostModel, k: int,
                    leftovers: FrozenSet[int] = frozenset(),
                    exact_max_candidates: int = 0) -> Dict[Role, Plan]:
    phi = lat.container_map()
    return {r: greedy_plan(lat, r, cm, k, phi=phi, leftovers=leftovers,
                           exact_max_candidates=exact_max_candidates)
            for r in lat.policy.roles()}


def avg_cost(lat: Lattice, plans: Dict[Role, Plan], cm: HNSWCostModel,
             k: int, weights: Optional[Dict[Role, float]] = None) -> float:
    """AvgCost(Q, I) for a uniform (or weighted) single-role workload (Eq. 2)."""
    roles = list(plans)
    if not roles:
        return 0.0
    if weights is None:
        return float(np.mean([plan_cost(lat, plans[r], r, cm, k)
                              for r in roles]))
    tot = sum(weights.get(r, 0.0) for r in roles) or 1.0
    return float(sum(weights.get(r, 0.0) * plan_cost(lat, plans[r], r, cm, k)
                     for r in roles) / tot)

"""The exclusive access-aware lattice (paper §3.2) and its operations.

Nodes hold sets of exclusive blocks; edges encode role-set containment with
adjacency.  ``copy`` and ``merge`` are the two primitive operations (§4) that
VEDA / EffVEDA apply to optimize the lattice under a storage budget.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

import numpy as np

from .policy import AccessPolicy, Role, RoleSet

NodeKey = Tuple  # ("ex", tau) | ("m", id) — hashable, stable across ops


@dataclasses.dataclass
class Node:
    """A lattice node: a group of exclusive blocks addressed by ``roles``.

    ``roles`` is the role set the node is *addressed by* (pure for, in
    EffVEDA's invariant); ``blocks`` the exclusive block ids it physically
    stores.  Size counts stored vectors (duplicates across nodes allowed,
    duplicates within a node impossible — ``blocks`` is a set).
    """

    key: NodeKey
    roles: RoleSet
    blocks: Set[int]

    def size(self, block_sizes: np.ndarray) -> int:
        return int(sum(int(block_sizes[b]) for b in self.blocks))

    def authorized_size(self, policy: AccessPolicy, r: Role,
                        block_sizes: np.ndarray) -> int:
        return int(sum(int(block_sizes[b]) for b in self.blocks
                       if r in policy.block_roles[b]))


class Lattice:
    """Mutable optimized lattice ``L`` (starts as a copy of ``L_ex``)."""

    def __init__(self, policy: AccessPolicy):
        self.policy = policy
        self.block_sizes = policy.block_sizes
        self.nodes: Dict[NodeKey, Node] = {}
        self._merge_counter = itertools.count()

    # ------------------------------------------------------------ construction
    @classmethod
    def exclusive(cls, policy: AccessPolicy) -> "Lattice":
        lat = cls(policy)
        for b, tau in enumerate(policy.block_roles):
            key = ("ex", tau)
            if key in lat.nodes:
                lat.nodes[key].blocks.add(b)
            else:
                lat.nodes[key] = Node(key=key, roles=tau, blocks={b})
        return lat

    def clone(self) -> "Lattice":
        lat = Lattice(self.policy)
        lat.nodes = {k: Node(key=v.key, roles=v.roles, blocks=set(v.blocks))
                     for k, v in self.nodes.items()}
        start = 1 + max((k[1] for k in self.nodes if k[0] == "m"), default=-1)
        lat._merge_counter = itertools.count(start)
        return lat

    # ------------------------------------------------------------------ sizes
    def node_size(self, key: NodeKey) -> int:
        return self.nodes[key].size(self.block_sizes)

    def total_stored(self) -> int:
        return int(sum(self.node_size(k) for k in self.nodes))

    def storage_amplification(self) -> float:
        return self.total_stored() / max(1, self.policy.n_vectors)

    # ------------------------------------------------------- lattice structure
    def layers(self) -> Dict[int, List[NodeKey]]:
        """Nodes grouped by ``|tau|`` (layer index; higher = broader access)."""
        out: Dict[int, List[NodeKey]] = {}
        for k, node in self.nodes.items():
            out.setdefault(len(node.roles), []).append(k)
        return out

    def ancestors(self, key: NodeKey) -> List[NodeKey]:
        """All nodes with a strictly smaller role set (child→ancestor paths)."""
        tau = self.nodes[key].roles
        return [k for k, n in self.nodes.items()
                if n.roles < tau]

    def descendants(self, key: NodeKey) -> List[NodeKey]:
        tau = self.nodes[key].roles
        return [k for k, n in self.nodes.items() if n.roles > tau]

    def siblings(self, key: NodeKey) -> List[NodeKey]:
        """Nodes sharing >=1 role with ``key`` that are neither anc nor desc."""
        tau = self.nodes[key].roles
        return [k for k, n in self.nodes.items()
                if k != key and (n.roles & tau)
                and not (n.roles < tau) and not (n.roles > tau)]

    def edges(self) -> List[Tuple[NodeKey, NodeKey]]:
        """Parent→child edges with containment + adjacency (§3.2)."""
        keys = list(self.nodes)
        out = []
        for pk in keys:
            ptau = self.nodes[pk].roles
            for ck in keys:
                ctau = self.nodes[ck].roles
                if not (ptau < ctau):
                    continue
                # adjacency: no intermediate node strictly between them
                if any(ptau < self.nodes[mk].roles < ctau for mk in keys):
                    continue
                out.append((pk, ck))
        return out

    def child_ancestor_pairs(self) -> List[Tuple[NodeKey, NodeKey]]:
        """All (child, ancestor) pairs along paths: ancestor.tau < child.tau."""
        out = []
        for ck in self.nodes:
            for ak in self.ancestors(ck):
                out.append((ck, ak))
        return out

    # ------------------------------------------------------------- operations
    def copy_blocks(self, src: NodeKey, dst: NodeKey,
                    source_blocks: Optional[Set[int]] = None) -> int:
        """Copy (duplicate) blocks of ``src`` into ``dst``; returns ΔS."""
        blocks = set(self.nodes[src].blocks if source_blocks is None
                     else source_blocks)
        new = blocks - self.nodes[dst].blocks
        delta = int(sum(int(self.block_sizes[b]) for b in new))
        self.nodes[dst].blocks |= new
        return delta

    def merge_into(self, src: NodeKey, dst: NodeKey) -> NodeKey:
        """Union ``src`` into ``dst`` and delete ``src`` (frees duplicates).

        The merged node is addressed by the union of both role sets: after the
        merge, queries for any role formerly routed to either node route here.
        """
        s, d = self.nodes[src], self.nodes[dst]
        d.blocks |= s.blocks
        merged_roles = d.roles | s.roles
        del self.nodes[src]
        if merged_roles != d.roles:
            new_key = ("m", next(self._merge_counter))
            while new_key in self.nodes:   # counter safety after clones
                new_key = ("m", next(self._merge_counter))
            node = Node(key=new_key, roles=merged_roles, blocks=d.blocks)
            del self.nodes[dst]
            self.nodes[new_key] = node
            return new_key
        return dst

    def delete(self, key: NodeKey) -> None:
        del self.nodes[key]

    def add_node(self, roles: RoleSet, blocks: Set[int],
                 key: Optional[NodeKey] = None) -> NodeKey:
        if key is None:
            key = ("m", next(self._merge_counter))
        assert key not in self.nodes
        self.nodes[key] = Node(key=key, roles=roles, blocks=set(blocks))
        return key

    # ---------------------------------------------------------------- queries
    def split_groups(self, key: NodeKey) -> Dict[RoleSet, Set[int]]:
        """Blocks of ``key`` grouped by their exact role combination τ_b.

        These are the per-τ pieces a drift-driven split decomposes the node
        into (core/compaction.py::reoptimize_node): each group is pure for
        its combination, so a piece either becomes a standalone node or —
        below the indexability threshold — a leftover scan block."""
        groups: Dict[RoleSet, Set[int]] = {}
        for b in self.nodes[key].blocks:
            groups.setdefault(self.policy.block_roles[b], set()).add(b)
        return groups

    def container_map(self) -> Dict[int, List[NodeKey]]:
        """Φ: exclusive block id → lattice nodes physically holding it (§6.1)."""
        phi: Dict[int, List[NodeKey]] = {}
        for k, node in self.nodes.items():
            for b in node.blocks:
                phi.setdefault(b, []).append(k)
        return phi

    def impurity(self, key: NodeKey, r: Role) -> float:
        """λ^r_idx = ceil(|D(idx)| / |D(idx) ∩ D(r)|) (Eq. 1). inf if no auth."""
        node = self.nodes[key]
        total = node.size(self.block_sizes)
        auth = node.authorized_size(self.policy, r, self.block_sizes)
        if auth == 0:
            return float("inf")
        return float(int(np.ceil(total / auth)))

    def is_pure(self, key: NodeKey, r: Role) -> bool:
        node = self.nodes[key]
        return all(r in self.policy.block_roles[b] for b in node.blocks)

    def check_invariants(self) -> None:
        """Every exclusive block must live in >=1 node (coverage)."""
        phi = self.container_map()
        missing = [b for b in range(self.policy.n_blocks) if b not in phi]
        assert not missing, f"blocks lost from lattice: {missing}"

"""Build the port's objects from another build's plain state.

A lattice build (policy, EffVEDA nodes, plans, leftovers) and the data it
indexes can be handed over as numpy arrays and Python containers — from a
saved build, or from the JAX reference package in the parity tests — so
that both packages search the same lattice over the same rows.  Nothing
here imports the reference: callers pass plain values.

  * :func:`policy_from_state` — ``n_roles``, ``block_roles`` (one role
    iterable per block) and ``block_members`` (one id array per block),
  * :func:`build_result_from_state` — node keys with their role sets and
    block sets, the per-role plans, the leftover blocks and the stats,
  * :func:`dataset_from_state` — vectors, queries and query roles.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

from .core.lattice import Lattice, Node, NodeKey
from .core.policy import AccessPolicy
from .core.queryplan import Plan
from .core.veda import BuildResult
from .data.pipeline import RetrievalDataset


def _key(key: Sequence) -> NodeKey:
    """Canonical node key: ``("ex", frozenset(roles))`` or ``("m", id)``."""
    kind, val = key
    if kind == "ex":
        return ("ex", frozenset(int(r) for r in val))
    return (str(kind), int(val))


def policy_from_state(n_roles: int, block_roles: Iterable[Iterable[int]],
                      block_members: Iterable[np.ndarray]) -> AccessPolicy:
    """An :class:`AccessPolicy` from its three fields."""
    return AccessPolicy(
        n_roles=int(n_roles),
        block_roles=tuple(frozenset(int(r) for r in tau)
                          for tau in block_roles),
        block_members=tuple(np.asarray(m, dtype=np.int64).copy()
                            for m in block_members))


def build_result_from_state(
        policy: AccessPolicy,
        nodes: Mapping[Sequence, Tuple[Iterable[int], Iterable[int]]],
        plans: Mapping[int, Tuple[Sequence[Sequence], Sequence[int]]],
        leftovers: Iterable[int],
        stats: Optional[Mapping[str, float]] = None) -> BuildResult:
    """A :class:`BuildResult` over ``policy``.

    ``nodes`` maps each node key to ``(roles, blocks)``; ``plans`` maps each
    role to ``(node keys, leftover blocks)`` in visit order.
    """
    lat = Lattice(policy)
    for key, (roles, blocks) in nodes.items():
        k = _key(key)
        lat.nodes[k] = Node(key=k, roles=frozenset(int(r) for r in roles),
                            blocks=set(int(b) for b in blocks))
    lat = lat.clone()              # sets the merge counter past every id
    return BuildResult(
        lattice=lat,
        leftovers=frozenset(int(b) for b in leftovers),
        plans={int(r): Plan(nodes=tuple(_key(k) for k in keys),
                            leftover_blocks=tuple(int(b) for b in left))
               for r, (keys, left) in plans.items()},
        stats=dict(stats or {}))


def dataset_from_state(vectors: np.ndarray, policy: AccessPolicy,
                       queries: np.ndarray,
                       query_roles: np.ndarray) -> RetrievalDataset:
    """A :class:`RetrievalDataset` from its arrays."""
    return RetrievalDataset(
        vectors=np.ascontiguousarray(vectors, dtype=np.float32),
        policy=policy,
        queries=np.ascontiguousarray(queries, dtype=np.float32),
        query_roles=np.asarray(query_roles, dtype=np.int64))

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
  * :func:`dataset_from_state` — vectors, queries and query roles,
  * :func:`params_from_state` — the generator LM's parameters, as the
    reference's ``init_params`` makes them (one leaf per name, stacked over
    layers), given as a nested dict of numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.lattice import Lattice, Node, NodeKey
from .core.policy import AccessPolicy
from .core.queryplan import Plan
from .core.veda import BuildResult
from .data.pipeline import RetrievalDataset
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig


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


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (numpy has no bfloat16 of
    its own, so they come as an extension dtype) travel as their bits.  The
    array is copied: the tensor owns its memory."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_state(cfg: ModelConfig, tree: Mapping,
                      device: DeviceLike = None) -> Dict:
    """The port's parameters (``models/model.py``: one dict per layer) from
    the reference's tree, whose layer leaves are stacked over layers.  The
    names and shapes are checked against the port's ``init_params``
    layout.  On ``device`` (``None`` → ``cuda``, which raises without a
    card)."""
    dev = resolve_device(device)
    d, vp, n_layers = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    h, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    top = {"embed": (vp, d), "final_norm": (d,), "lm_head": (d, vp)}
    per_layer = {("ln1",): (d,), ("ln2",): (d,),
                 ("attn", "wq"): (d, h * hd), ("attn", "wk"): (d, hkv * hd),
                 ("attn", "wv"): (d, hkv * hd), ("attn", "wo"): (h * hd, d),
                 ("mlp", "w_gate"): (d, f), ("mlp", "w_up"): (d, f),
                 ("mlp", "w_down"): (f, d)}
    want = set(top) | {"layers"}
    if set(tree) != want:
        raise ValueError(f"expected the keys {sorted(want)}, got "
                         f"{sorted(tree)}")
    out: Dict = {}
    for name, shape in top.items():
        if tuple(tree[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tree[name].shape)}, "
                             f"expected {shape}")
        out[name] = _tensor(tree[name], dev)
    layers = [{"attn": {}, "mlp": {}} for _ in range(n_layers)]
    for path, shape in per_layer.items():
        leaf = tree["layers"]
        for key in path:
            leaf = leaf[key]
        if tuple(leaf.shape) != (n_layers,) + shape:
            raise ValueError(f"layers/{'/'.join(path)} has shape "
                             f"{tuple(leaf.shape)}, expected "
                             f"{(n_layers,) + shape}")
        stacked = _tensor(leaf, dev)
        for i in range(n_layers):
            node = layers[i]
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = stacked[i]
    out["layers"] = layers
    return out

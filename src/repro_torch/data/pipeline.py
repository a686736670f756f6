"""Deterministic synthetic retrieval data.

``RetrievalDataset`` synthesizes clustered vectors + an RBAC policy + a query
workload for the paper's experiments (SIFT-like unit-scale features, Zipf
block sizes).  The generator is numpy, drawing in the same order as the
reference, so one seed gives the same dataset in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.policy import AccessPolicy, generate_policy


@dataclasses.dataclass
class RetrievalDataset:
    vectors: np.ndarray
    policy: AccessPolicy
    queries: np.ndarray
    query_roles: np.ndarray

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


def make_retrieval_dataset(n_vectors: int = 20_000, dim: int = 32,
                           n_roles: int = 12, n_permissions: int = 40,
                           n_queries: int = 100, n_clusters: int = 64,
                           sensitivity: float = 1.0, seed: int = 0,
                           block_zipf=(1.0, 1.5), perm_zipf=(2.0, 1.5),
                           ) -> RetrievalDataset:
    """Clustered synthetic vectors + RBAC policy + query workload (§7.1).

    ``sensitivity``: probability a query vector is drawn from the queried
    role's own data (1.0 = always, 0.0 = never — paper Exp 12).
    """
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, n_vectors)
    vecs = centers[assign] + rng.standard_normal(
        (n_vectors, dim)).astype(np.float32)
    policy = generate_policy(n_vectors, n_roles=n_roles,
                             n_permissions=n_permissions,
                             block_zipf=block_zipf, perm_zipf=perm_zipf,
                             seed=seed + 1)
    roles = rng.integers(0, n_roles, n_queries)
    qs = np.empty((n_queries, dim), np.float32)
    for i, r in enumerate(roles):
        own = rng.random() < sensitivity
        ids = policy.d_of_role(int(r))
        if own and len(ids):
            base = vecs[ids[rng.integers(len(ids))]]
        else:
            mask = np.ones(n_vectors, bool)
            mask[policy.d_of_role(int(r))] = False
            pool = np.flatnonzero(mask)
            src = pool if len(pool) else np.arange(n_vectors)
            base = vecs[src[rng.integers(len(src))]]
        qs[i] = base + 0.1 * rng.standard_normal(dim).astype(np.float32)
    return RetrievalDataset(vectors=vecs, policy=policy, queries=qs,
                            query_roles=roles.astype(np.int64))

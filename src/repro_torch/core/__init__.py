"""repro_torch.core — access-aware lattice indexing and the search paths.

Public API:
  generate_policy / AccessPolicy     — RBAC datasets (§3.1)
  Lattice                            — exclusive lattice + copy/merge (§3.2)
  HNSWCostModel                      — Def 2.2 cost model
  build_veda / build_effveda         — §4 / §5 optimizers → BuildResult
  build_vector_storage               — physical engines per node
  Query / SearchResult / Engine protocols — the typed retrieval contract
  VectorStore.search(queries)        — THE retrieval entry point
  coordinated_search                 — §6.2 per-query path
  execute_queries / BatchTopK        — the batched path
  metrics                            — brute-force oracle / recall
"""
from .policy import (MASK_WORD_BITS, AccessPolicy, generate_policy,
                     mask_words, roles_kernel_mask, roles_word_mask)
from .lattice import Lattice, Node
from .costmodel import CostModel, HNSWCostModel
from .queryplan import Plan, build_all_plans, greedy_plan, plan_cost, avg_cost
from .veda import BuildResult, VedaBuilder, build_veda
from .effveda import EffVedaBuilder, build_effveda
from .predicate import PredicateSchema
from .api import (DEFAULT_MIN_PACKED_BATCH, BatchEngine, Engine,
                  MaskedEngine, MutableEngine, Query, ResumableEngine,
                  SLOClass, SearchResult, SearchStats, supports_batch)
from .store import VectorStore, build_vector_storage, exact_factory
from .coordinated import coordinated_search
from .batched import BatchTopK, execute_queries
from . import metrics

__all__ = [
    "AccessPolicy", "generate_policy", "Lattice", "Node",
    "MASK_WORD_BITS", "mask_words", "roles_word_mask", "roles_kernel_mask",
    "CostModel", "HNSWCostModel",
    "Plan", "build_all_plans", "greedy_plan", "plan_cost", "avg_cost",
    "BuildResult", "VedaBuilder", "build_veda",
    "EffVedaBuilder", "build_effveda", "PredicateSchema",
    "Query", "SearchResult", "SearchStats", "SLOClass",
    "Engine", "ResumableEngine", "MaskedEngine", "BatchEngine",
    "MutableEngine", "supports_batch", "DEFAULT_MIN_PACKED_BATCH",
    "VectorStore", "build_vector_storage", "exact_factory",
    "coordinated_search", "metrics",
    "BatchTopK", "execute_queries",
]

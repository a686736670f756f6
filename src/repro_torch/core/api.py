"""The unified retrieval contract (DESIGN.md §Query API).

Every retrieval path executes through one typed interface:

  * :class:`Query` — what a caller asks for: a vector, the role set it is
    authorized under (one or many; multi-role queries take union semantics,
    paper §6 / Exp 14), ``k``, ``efs`` for beam engines, an optional
    ``where`` predicate clause, and scheduling metadata: an
    :class:`SLOClass` (``slo``), an optional ``deadline_ms`` and a free-form
    ``tag``.
  * :class:`SearchResult` — what a caller gets back: sorted authorized
    ``(dist, id)`` hits, this query's :class:`SearchStats`, and which
    execution path produced it.
  * The :class:`Engine` protocol hierarchy — what a lattice-node index must
    provide, with optional capabilities (:class:`ResumableEngine`,
    :class:`MaskedEngine`, :class:`BatchEngine`, :class:`MutableEngine`).
    Capability checks are ``isinstance`` against these runtime-checkable
    protocols; no ``hasattr`` probes.

The entry point itself is ``VectorStore.search(queries)`` (core/store.py):
it builds a plan cover for each query's role set, routes the whole batch
through the batched engine when every node engine is a :class:`BatchEngine`,
and falls back to per-query coordinated search otherwise.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import (Iterable, Iterator, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np

from .policy import Role

# Packed-leftover-shard batch threshold: below this micro-batch size the
# per-block leftover path is used.  ``packed=True`` still forces the shard
# regardless of batch size.
DEFAULT_MIN_PACKED_BATCH = 16


# --------------------------------------------------------------------- stats
@dataclasses.dataclass
class SearchStats:
    """Per-query retrieval accounting (Exp 9: skip rate, efs savings).

    ``indices_visited`` / ``data_touched`` / ``data_authorized_touched`` /
    ``leftover_vectors_scanned`` are *deterministic*: they count logical
    (row, node/block) visits and match across the sequential and batched
    engines for identical queries.  ``impure_visits`` / ``phase2_skipped`` /
    ``efs_*`` depend on the visit schedule (bounds tighten in execution
    order), so they may differ between engines — see DESIGN.md §Batched
    Execution.
    """

    impure_visits: int = 0
    phase2_skipped: int = 0
    efs_used: float = 0.0
    efs_worst_case: float = 0.0
    indices_visited: int = 0
    leftover_vectors_scanned: int = 0
    data_touched: int = 0
    data_authorized_touched: int = 0

    def merge(self, o: "SearchStats") -> None:
        """Accumulate another query's counters into this one (field-wise
        sum) — how serving layers aggregate a batch into one record."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))

    @property
    def skip_rate(self) -> float:
        """Fraction of impure-node visit opportunities pruned by the
        coordinated bound (paper Table 5)."""
        return (self.phase2_skipped / self.impure_visits
                if self.impure_visits else 1.0)

    @property
    def efs_savings(self) -> float:
        """Relative beam-width saving on impure nodes vs the worst case
        (paper Table 6; beam engines only — scan engines report 0)."""
        if self.efs_worst_case <= 0:
            return 0.0
        return 1.0 - self.efs_used / self.efs_worst_case

    @property
    def purity(self) -> float:
        """Fraction of touched vectors the querying role was authorized
        for (paper Fig. 6b) — 1.0 means no wasted scanning."""
        if self.data_touched == 0:
            return 1.0
        return self.data_authorized_touched / self.data_touched


# ----------------------------------------------------------------------- slo
class SLOClass(enum.IntEnum):
    """Scheduling class a query is served under (DESIGN.md §SLO-Aware
    Serving), ordered by urgency.  The store ignores it; the serving layer
    cuts micro-batches INTERACTIVE-first and sheds BULK first."""

    BULK = 0
    STANDARD = 1
    INTERACTIVE = 2


# --------------------------------------------------------------------- query
@dataclasses.dataclass(frozen=True, eq=False)
class Query:
    """One typed retrieval request.

    ``roles`` is the set of roles the query is authorized under — one role
    for the common case, several for union-semantics multi-role queries
    (``D(roles) = U_r D(r)``).  ``efs`` only matters for beam engines; scan
    engines are exact and ignore it.

    ``where`` is an optional conjunction of predicate atoms over the store's
    :class:`~repro_torch.core.predicate.PredicateSchema` — ``("has", field,
    tag)``, ``("lacks", field, tag)``, ``("ge", field, edge)``, ``("lt",
    field, edge)`` — compiled to (require, forbid) packed word rows and
    evaluated in-kernel beside the auth check (DESIGN.md §Hybrid Filtered
    Search).  ``None`` / empty means unfiltered.
    """

    vector: np.ndarray
    roles: Tuple[Role, ...]
    k: int = 10
    efs: int = 50
    where: Optional[Tuple[Tuple, ...]] = None
    slo: SLOClass = SLOClass.STANDARD
    deadline_ms: Optional[float] = None
    tag: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "vector",
                           np.asarray(self.vector, dtype=np.float32))
        roles = self.roles
        if isinstance(roles, (int, np.integer)):
            roles = (int(roles),)
        # canonical form (dedup + sort): every role-set-keyed cache — masks,
        # plan covers, node purity — then shares entries across permutations
        roles = tuple(sorted(set(int(r) for r in roles)))
        if not roles:
            raise ValueError("a query must carry at least one role")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        object.__setattr__(self, "roles", roles)
        # where: canonical (dedup + sort) atom tuple; empty collapses to None
        if self.where is not None:
            atoms = tuple(sorted(set(tuple(a) for a in self.where)))
            object.__setattr__(self, "where", atoms or None)
        if not isinstance(self.slo, SLOClass):
            raise TypeError(f"slo must be an SLOClass, got {self.slo!r}")
        if self.deadline_ms is not None:
            dl = float(self.deadline_ms)
            if dl <= 0:
                raise ValueError(f"deadline_ms must be positive, got {dl}")
            object.__setattr__(self, "deadline_ms", dl)

    @classmethod
    def single(cls, vector: np.ndarray, role: Role, k: int = 10,
               efs: int = 50, **kw) -> "Query":
        """Convenience constructor for the one-role common case."""
        return cls(vector=vector, roles=(int(role),), k=int(k), efs=int(efs),
                   **kw)


@dataclasses.dataclass
class SearchResult:
    """Sorted authorized ``(dist, id)`` hits plus this query's accounting.

    Sequence-like over ``hits``.  ``path`` names the execution strategy that
    produced the result: ``"batched+packed"`` / ``"batched"`` (batched
    engine, packed vs per-block leftovers) or ``"sequential"`` (per-query
    coordinated search).
    """

    hits: List[Tuple[float, int]]
    stats: SearchStats = dataclasses.field(default_factory=SearchStats)
    path: str = "sequential"

    @property
    def ids(self) -> List[int]:
        return [v for _, v in self.hits]

    @property
    def dists(self) -> List[float]:
        return [d for d, _ in self.hits]

    def __iter__(self) -> Iterator[Tuple[float, int]]:
        return iter(self.hits)

    def __len__(self) -> int:
        return len(self.hits)

    def __getitem__(self, i):
        return self.hits[i]


#: What ``VectorStore.search`` accepts: one :class:`Query` or any sequence of
#: them (normalized by :func:`as_queries`).
QueryLike = Union[Query, Sequence[Query]]


def as_queries(queries: QueryLike) -> List[Query]:
    """Normalize the ``VectorStore.search`` argument to a list of queries."""
    if isinstance(queries, Query):
        return [queries]
    out = list(queries)
    if not all(isinstance(q, Query) for q in out):
        raise TypeError("store.search takes Query objects; use "
                        "Query.single(...) to build one")
    return out


# ----------------------------------------------------------------- protocols
@runtime_checkable
class Engine(Protocol):
    """Minimal lattice-node index: dense ids + plain top-k search."""

    ids: np.ndarray

    def __len__(self) -> int: ...

    def search(self, q: np.ndarray, k: int, efs: int = ...
               ) -> List[Tuple[float, int]]: ...


@runtime_checkable
class ResumableEngine(Engine, Protocol):
    """Beam engine whose base-layer search can resume with a larger beam
    (paper Alg. 17): required by coordinated search's impure phase-2."""

    def begin_search(self, q: np.ndarray, efs: int): ...

    def resume_search(self, q: np.ndarray, state, efs: int): ...


@runtime_checkable
class MaskedEngine(Engine, Protocol):
    """Engine with an in-kernel authorization filter (per-vector role bits)."""

    auth_bits: np.ndarray

    def search_masked(self, q: np.ndarray, k: int, role_mask,
                      bound: Optional[float] = ...
                      ) -> List[Tuple[float, int]]: ...


@runtime_checkable
class BatchEngine(Engine, Protocol):
    """Engine the batched execution path can drive: one launch scores a whole
    query batch with per-query role bits and bounds, and node-level pruning
    comes from centroid-radius lower bounds."""

    def search_masked_batch(self, qs: np.ndarray, k: int,
                            role_masks: np.ndarray,
                            bounds: Optional[np.ndarray] = ...
                            ) -> Tuple[np.ndarray, np.ndarray]: ...

    def lower_bounds(self, qs: np.ndarray) -> np.ndarray: ...


@runtime_checkable
class MutableEngine(Engine, Protocol):
    """Engine supporting in-place growth and tombstoning (Appendix I)."""

    def insert(self, vid: int, vec: np.ndarray) -> None: ...

    def tombstone(self, vid: int) -> None: ...


def supports_batch(engines: Iterable[object]) -> bool:
    """True when every engine can take the batched path (an empty engine set
    qualifies: leftover-only stores are batch-amortized too)."""
    return all(isinstance(e, BatchEngine) for e in engines)

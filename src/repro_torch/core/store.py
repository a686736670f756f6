"""Physical vector storage built from an optimized lattice (Alg. 1 line 12).

``build_vector_storage`` materializes one engine per indexable lattice node
plus packed leftover arrays, and retains the per-role query plans.  The
engine is pluggable: the device ScoreScan engine (ann/scorescan.py over
kernels/l2_topk) or the exact host scan (ann/exact.py).

``VectorStore.search(queries)`` is the single retrieval entry point
(DESIGN.md §Query API): it builds a plan cover for each query's role set,
routes the batch through the batched lattice engine when every node engine
is a :class:`~repro_torch.core.api.BatchEngine`, and falls back to
per-query coordinated search otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ann.exact import ExactIndex
from ..ann.scorescan import pack_leftover_shard, scorescan_factory
from ..device import DeviceLike
from .api import (DEFAULT_MIN_PACKED_BATCH, Query, QueryLike, SearchResult,
                  SearchStats, as_queries, supports_batch)
from .lattice import Lattice, NodeKey
from .policy import (AccessPolicy, Role, mask_words, roles_kernel_mask,
                     roles_word_mask)
from .predicate import (PredicateSchema, bit_population, estimate_selectivity,
                        predicate_pass)
from .queryplan import Plan
from .veda import BuildResult

EngineFactory = Callable[[np.ndarray, np.ndarray], object]


def exact_factory() -> EngineFactory:
    return lambda data, ids: ExactIndex(data, ids=ids)


@dataclasses.dataclass
class VectorStore:
    """Built storage: engines per node, leftover arrays, plans, policy."""

    data: np.ndarray
    policy: AccessPolicy
    lattice: Lattice
    plans: Dict[Role, Plan]
    engines: Dict[NodeKey, object]
    leftover_vectors: Dict[int, np.ndarray]        # block id → (m, d) array
    leftover_ids: Dict[int, np.ndarray]            # block id → vector ids
    leftover_shard: Optional[object] = None        # packed ScoreScan leftovers
    pred_schema: Optional[PredicateSchema] = None  # predicate-plane layout
    attr_words: Optional[np.ndarray] = None        # (N, P) uint32 attr words
    cost_model: Optional[object] = None            # routing cost model
    route_by_selectivity: bool = True              # predicate-aware routing
    device: DeviceLike = None                      # packed shard's device
    _auth_cache: Dict[Role, np.ndarray] = dataclasses.field(default_factory=dict)
    _plan_cache: Dict[Tuple[Role, ...], Plan] = dataclasses.field(
        default_factory=dict)
    _pred_counts: Optional[np.ndarray] = None      # per-bit population counts
    _pred_live: Optional[int] = None               # live rows behind counts

    def authorized_mask(self, r: Role) -> np.ndarray:
        if r not in self._auth_cache:
            self._auth_cache[r] = self.policy.authorized_mask(r)
        return self._auth_cache[r]

    def authorized_mask_multi(self, roles: Sequence[Role]) -> np.ndarray:
        mask = np.zeros(len(self.data), dtype=bool)
        for r in roles:
            mask |= self.authorized_mask(r)
        return mask

    # --------------------------------------------------------- role masks
    @property
    def mask_width(self) -> int:
        """In-kernel auth-mask width in packed uint32 words
        (``W = ceil(n_roles/32)``; 1 = the single-word fast path)."""
        return mask_words(self.policy.n_roles)

    def kernel_role_mask(self, roles: Sequence[Role]):
        """In-kernel filter operand for one role set: ``np.uint32`` scalar
        when the store's role universe fits one word, else a ``(W,)`` uint32
        word array (exact — roles never alias)."""
        return roles_kernel_mask(roles, self.policy.n_roles)

    def role_mask_rows(self, role_sets: Sequence[Sequence[Role]]
                       ) -> np.ndarray:
        """Per-query in-kernel role filter rows for a batch: ``(B,)`` uint32
        when the role universe fits one word, else ``(B, W)`` word rows —
        the layout ``search_masked_batch`` threads into one launch."""
        w = self.mask_width
        rows = np.stack([roles_word_mask(t, width=w) for t in role_sets])
        return rows[:, 0] if w == 1 else rows

    # ------------------------------------------------------- predicate plane
    def compile_where(self, where) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Compile a query's ``where`` clause to (require, forbid) word rows
        against the store's schema; ``None`` for the unfiltered path.  A
        filtered query against a store with no predicate plane is a hard
        error — never a silently unfiltered answer."""
        if not where:
            return None
        if self.pred_schema is None or self.attr_words is None:
            raise ValueError(
                "query carries a where clause but the store has no "
                "predicate plane (pred_schema/attr_words)")
        return self.pred_schema.compile_where(where)

    def predicate_rows(self, queries: Sequence[Query]
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Per-query (B, P) require/forbid rows for a batch, or ``None``
        when no query is filtered (the exact P=0 kernel path)."""
        if not any(q.where for q in queries):
            return None
        p = self.pred_width
        req = np.zeros((len(queries), p), np.uint32)
        forb = np.zeros((len(queries), p), np.uint32)
        for row, q in enumerate(queries):
            rf = self.compile_where(q.where)
            if rf is not None:
                req[row], forb[row] = rf
        return req, forb

    @property
    def pred_width(self) -> int:
        """Predicate-plane width P in packed uint32 words (0 = no plane)."""
        if self.attr_words is None:
            return 0
        return 1 if self.attr_words.ndim == 1 else self.attr_words.shape[1]

    def predicate_mask(self, require, forbid) -> np.ndarray:
        """Host-side (N,) bool pass mask over the store's attribute words —
        the post-filter for engines that cannot evaluate predicates
        in-kernel, and the leftover-scan filter."""
        assert self.attr_words is not None
        return predicate_pass(self.attr_words, require, forbid)

    def pred_bit_counts(self) -> Optional[np.ndarray]:
        """Per-bit population counts over the attribute plane — the
        selectivity estimator's sufficient statistic.  Computed lazily from
        ``attr_words``; dynamic stores maintain it incrementally through
        :meth:`note_attr_rows`."""
        if self.attr_words is None:
            return None
        if self._pred_counts is None:
            self._pred_counts = bit_population(self.attr_words,
                                               self.pred_width)
            self._pred_live = int(len(self.attr_words))
        return self._pred_counts

    def note_attr_rows(self, words, sign: int = 1) -> None:
        """Incrementally fold inserted (+1) / deleted (-1) attribute rows
        into the population counts (no full recount under churn)."""
        if self.attr_words is None or self.pred_bit_counts() is None:
            return
        from .predicate import row_bits
        w = np.asarray(words, np.uint32)
        rows = w[None, :] if w.ndim == 1 else w
        for r in rows:
            self._pred_counts += int(sign) * row_bits(r).astype(np.int64)
        self._pred_live = max(0, int(self._pred_live) + int(sign) * len(rows))

    def where_selectivity(self, where) -> float:
        """Independence-model selectivity estimate of a ``where`` clause in
        [1/n, 1]; 1.0 for unfiltered queries or attribute-less stores."""
        rf = self.compile_where(where)
        counts = self.pred_bit_counts()
        if rf is None or counts is None:
            return 1.0
        n = self._pred_live or len(self.attr_words)
        return estimate_selectivity(rf[0], rf[1], counts, n)

    def invalidate_caches(self) -> None:
        """Drop every derived structure that depends on policy/plan/leftover
        state — dynamic stores (Appendix I) call this after each mutation.
        The packed leftover shard is included: it is rebuilt on demand.
        Predicate population counts are NOT dropped — dynamic stores maintain
        them incrementally via :meth:`note_attr_rows`."""
        self._auth_cache.clear()
        self._plan_cache.clear()
        self.leftover_shard = None

    # ------------------------------------------------------------ query plans
    def plan_for_roles(self, roles: Sequence[Role]) -> Plan:
        """Plan cover for a role set: the single-role plan as built, or the
        cached union of per-role plans (node dedup; leftover blocks already
        covered by a selected node are dropped) for multi-role queries."""
        roles = tuple(dict.fromkeys(int(r) for r in roles))
        assert roles, "a plan cover needs at least one role"
        if len(roles) == 1:
            return self.plans[roles[0]]
        key = tuple(sorted(roles))
        if key not in self._plan_cache:
            nodes: List[NodeKey] = []
            seen = set()
            left: set = set()
            for r in key:
                p = self.plans[r]
                for nk in p.nodes:
                    if nk not in seen:
                        seen.add(nk)
                        nodes.append(nk)
                left |= set(p.leftover_blocks)
            covered: set = set()
            for nk in nodes:
                covered |= self.lattice.nodes[nk].blocks
            self._plan_cache[key] = Plan(
                nodes=tuple(nodes), leftover_blocks=tuple(sorted(left - covered)))
        return self._plan_cache[key]

    # ----------------------------------------------------------- entry point
    def batched_capable(self) -> bool:
        """Whether retrieval can take the batched engine: every node engine
        is a :class:`~repro_torch.core.api.BatchEngine` (leftover-only stores
        qualify — their sweep is batch-amortized too)."""
        return supports_batch(self.engines.values())

    def search(self, queries: QueryLike, *,
               packed: Optional[bool] = None,
               min_packed_batch: int = DEFAULT_MIN_PACKED_BATCH
               ) -> List[SearchResult]:
        """THE retrieval entry point: authorized top-k for a query batch.

        Each :class:`Query` may carry one role or several (union semantics);
        a plan cover is built per role set.  When every node engine supports
        the batch kernel path the whole batch executes in one lattice sweep
        with heterogeneous per-query ``k`` threaded through (each row's
        pruning bound uses its *own* k-th distance, not the batch max);
        otherwise each query runs per-query coordinated search with its own
        ``efs``.  ``packed``/``min_packed_batch`` select the leftover
        strategy for the batched path (DESIGN.md §Continuous Batching):
        ``True`` forces the packed shard, ``False`` the per-block scans, and
        ``None`` uses the shard iff it is built and the batch has at least
        ``min_packed_batch`` rows (exp16 calibration).
        """
        queries = as_queries(queries)
        if not queries:
            return []
        if self.batched_capable():
            from .batched import execute_queries
            return execute_queries(self, queries, packed=packed,
                                   min_packed_batch=min_packed_batch)
        from .coordinated import coordinated_search
        out = []
        for q in queries:
            stats = SearchStats()
            hits = coordinated_search(
                self, q.vector, q.roles[0], q.k, q.efs, stats=stats,
                roles=q.roles if len(q.roles) > 1 else None,
                where=q.where)
            out.append(SearchResult(hits=hits, stats=stats, path="sequential"))
        return out

    def node_total_and_auth(self, key: NodeKey, mask: np.ndarray
                            ) -> Tuple[int, int]:
        node = self.lattice.nodes[key]
        total, auth = 0, 0
        for b in node.blocks:
            members = self.policy.block_members[b]
            if not len(members):
                # deletes can empty a block; it contributes nothing either way
                continue
            total += len(members)
            if mask[members[0]]:
                auth += len(members)
        return total, auth

    def is_pure(self, key: NodeKey, mask: np.ndarray) -> bool:
        total, auth = self.node_total_and_auth(key, mask)
        return auth == total

    def pack_leftover_shard(self):
        """Build (once) the packed leftover shard: every leftover block
        concatenated into one auth-masked ScoreScan index on the store's
        ``device``, so a micro-batch's leftover phase is a single
        ``l2_topk`` launch instead of one scan + merge per block (DESIGN.md
        §Continuous Batching).

        Returns the shard, or ``None`` when there are no leftovers.  Role
        universes of any width pack exactly — the shard's auth masks are
        multi-word past 32 roles (DESIGN.md §Role Masks).
        """
        if self.leftover_shard is None:
            self.leftover_shard = pack_leftover_shard(
                self.leftover_vectors, self.leftover_ids, self.policy,
                attr_words=self.attr_words, device=self.device)
        return self.leftover_shard

    def stored_vectors(self) -> int:
        n = sum(len(e.ids) for e in self.engines.values())
        n += sum(len(v) for v in self.leftover_vectors.values())
        return int(n)

    def sa(self) -> float:
        return self.stored_vectors() / max(1, len(self.data))


def build_vector_storage(result: BuildResult, data: np.ndarray,
                         engine_factory: Optional[EngineFactory] = None,
                         pack_leftovers: bool = False,
                         pred_schema: Optional[PredicateSchema] = None,
                         attr_words: Optional[np.ndarray] = None,
                         cost_model: Optional[object] = None,
                         device: DeviceLike = None,
                         ) -> VectorStore:
    """Materialize the engines of ``result``'s lattice over ``data``.

    ``device`` is where the packed leftover shard lives (``None`` →
    ``cuda``, which raises without a card).  Node engines live wherever
    ``engine_factory`` puts them; the default is ScoreScan engines on
    ``device``.  Pass :func:`exact_factory` for host engines (the
    sequential path)."""
    lat = result.lattice
    policy = lat.policy
    if attr_words is not None:
        attr_words = np.ascontiguousarray(attr_words, dtype=np.uint32)
        if attr_words.ndim == 1:
            attr_words = attr_words[:, None]
        if len(attr_words) != len(data):
            raise ValueError(f"attr_words has {len(attr_words)} rows for "
                             f"{len(data)} vectors")
    factory = engine_factory or scorescan_factory(
        policy, attr_words=attr_words, device=device)
    engines: Dict[NodeKey, object] = {}
    for key, node in lat.nodes.items():
        ids = np.concatenate([policy.block_members[b]
                              for b in sorted(node.blocks)])
        engines[key] = factory(data[ids], ids)
    leftover_vectors, leftover_ids = {}, {}
    for b in result.leftovers:
        ids = policy.block_members[b]
        leftover_ids[b] = ids
        leftover_vectors[b] = np.ascontiguousarray(data[ids], dtype=np.float32)
    store = VectorStore(data=np.ascontiguousarray(data, dtype=np.float32),
                        policy=policy, lattice=lat, plans=dict(result.plans),
                        engines=engines, leftover_vectors=leftover_vectors,
                        leftover_ids=leftover_ids,
                        pred_schema=pred_schema, attr_words=attr_words,
                        cost_model=cost_model, device=device)
    if pack_leftovers:
        store.pack_leftover_shard()
    return store


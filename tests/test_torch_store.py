"""``VectorStore.search`` in the port (device="cpu") against the JAX store.

The JAX package builds the dataset and the EffVEDA lattice; ``carry.py``
hands that state to the port, so both stores search the same lattice over
the same rows.  Every path — ``batched+packed``, ``batched`` and
``sequential`` — is held to the reference store's hits and to the
brute-force authorized oracle under the port's parity rule.
"""
import functools

import numpy as np
import pytest

from repro import core as jcore
from repro.ann.scorescan import scorescan_factory as jax_scorescan
from repro.core.predicate import PredicateSchema as JaxSchema
from repro.data.pipeline import make_retrieval_dataset
from repro_torch import carry
from repro_torch import core as tcore
from repro_torch.ann.scorescan import scorescan_factory
from repro_torch.core import metrics
from repro_torch.core.predicate import PredicateSchema
from repro_torch.kernels.l2_topk import ops

TAGS = {"color": tuple(f"c{i}" for i in range(20))}
RANGES = {"price": (0.0, 10.0, 20.0, 30.0)}


@functools.lru_cache(maxsize=None)
def _state(n_roles, lam, pred=False, n=1500, dim=8, seed=0):
    """Reference dataset + build, and the port's copy of both."""
    ds = make_retrieval_dataset(n_vectors=n, dim=dim, n_roles=n_roles,
                                n_permissions=n_roles + 16, n_queries=24,
                                seed=seed)
    res = jcore.build_effveda(ds.policy,
                              jcore.HNSWCostModel(lam_threshold=lam),
                              beta=1.1, k=10)
    pol = carry.policy_from_state(ds.policy.n_roles, ds.policy.block_roles,
                                  ds.policy.block_members)
    tres = carry.build_result_from_state(
        pol, {k: (v.roles, v.blocks) for k, v in res.lattice.nodes.items()},
        {r: (p.nodes, p.leftover_blocks) for r, p in res.plans.items()},
        res.leftovers, res.stats)
    attrs = None
    if pred:
        rng = np.random.default_rng(seed + 99)
        rows = [{"color": f"c{int(c)}", "price": float(v)}
                for c, v in zip(rng.integers(0, 20, n),
                                rng.uniform(0, 40, n))]
        attrs = PredicateSchema.make(tags=TAGS, ranges=RANGES).encode_rows(
            rows)
    return ds, res, pol, tres, attrs


def _stores(n_roles, lam, scan, pred=False, packed=True):
    ds, res, pol, tres, attrs = _state(n_roles, lam, pred)
    pk = {}
    tpk = {}
    if pred:
        pk = dict(pred_schema=JaxSchema.make(tags=TAGS, ranges=RANGES),
                  attr_words=attrs)
        tpk = dict(pred_schema=PredicateSchema.make(tags=TAGS, ranges=RANGES),
                   attr_words=attrs)
    if scan:
        jf = jax_scorescan(ds.policy, attr_words=attrs)
        tf = scorescan_factory(pol, attr_words=attrs, device="cpu")
    else:
        jf, tf = jcore.exact_factory(), tcore.exact_factory()
    js = jcore.build_vector_storage(res, ds.vectors, engine_factory=jf,
                                    pack_leftovers=packed, **pk)
    ts = tcore.build_vector_storage(tres, ds.vectors, engine_factory=tf,
                                    pack_leftovers=packed, device="cpu",
                                    **tpk)
    return ds, js, ts


def _pad(hits, k):
    d = np.full(k, np.inf)
    i = np.full(k, -1, np.int64)
    for j, (dd, ii) in enumerate(hits[:k]):
        d[j], i[j] = dd, ii
    return d, i


def _agree(hits, ref_hits, k, scale):
    d, i = _pad(hits, k)
    rd, ri = _pad(ref_hits, k)
    return metrics.topk_agreement(d[None], i[None], rd[None], ri[None],
                                  np.asarray([scale]))


def _held(ds, ts, jres, tres, queries, jqueries, pred_masks=None):
    scale = metrics.norm_scale(np.stack([q.vector for q in queries]),
                               ds.vectors)
    for n, (q, a, b) in enumerate(zip(queries, jres, tres)):
        mask = ts.authorized_mask_multi(q.roles)
        if pred_masks is not None and pred_masks[n] is not None:
            mask = mask & pred_masks[n]
        truth = metrics.brute_force_topk(ds.vectors, mask, q.vector, q.k)
        assert len(b) == len(truth) <= q.k
        for ref in (a.hits, truth):
            res = _agree(b.hits, ref, q.k, scale[n])
            assert res["ok"], (n, b.hits, ref, res)


def _queries(ds, make, multi=False, ks=False, where=None):
    out = []
    for n, (v, r) in enumerate(zip(ds.queries, ds.query_roles)):
        roles = (int(r), int((r + 3) % ds.policy.n_roles)) if multi and n % 2 \
            else (int(r),)
        k = 1 + n % 12 if ks else 10
        w = where if where is not None and n % 2 == 0 else None
        out.append(make(vector=v, roles=roles, k=k, where=w))
    return out


@pytest.mark.parametrize("packed,path", [(True, "batched+packed"),
                                         (False, "batched")])
def test_batched_paths_match_reference_store(packed, path):
    ds, js, ts = _stores(8, 60, scan=True, packed=packed)
    tq = _queries(ds, tcore.Query)
    jq = _queries(ds, jcore.Query)
    tres, jres = ts.search(tq), js.search(jq)
    assert {r.path for r in tres} == {path} == {r.path for r in jres}
    _held(ds, ts, jres, tres, tq, jq)
    for a, b in zip(jres, tres):
        assert a.stats.indices_visited == b.stats.indices_visited
        assert a.stats.data_touched == b.stats.data_touched


def test_sequential_path_matches_reference_store():
    ds, js, ts = _stores(8, 60, scan=False)
    tq = _queries(ds, tcore.Query, multi=True)
    jq = _queries(ds, jcore.Query, multi=True)
    tres, jres = ts.search(tq), js.search(jq)
    assert {r.path for r in tres} == {"sequential"}
    _held(ds, ts, jres, tres, tq, jq)


def test_multi_role_heterogeneous_k_two_words():
    ds, js, ts = _stores(40, 60, scan=True)
    assert ts.mask_width == 2
    tq = _queries(ds, tcore.Query, multi=True, ks=True)
    jq = _queries(ds, jcore.Query, multi=True, ks=True)
    tres, jres = ts.search(tq, packed=True), js.search(jq, packed=True)
    assert {r.path for r in tres} == {"batched+packed"}
    _held(ds, ts, jres, tres, tq, jq)


def test_where_clause_on_half_the_queries():
    ds, js, ts = _stores(8, 60, scan=True, pred=True)
    where = (("has", "color", "c3"), ("ge", "price", 10.0))
    tq = _queries(ds, tcore.Query, where=where)
    jq = _queries(ds, jcore.Query, where=where)
    tres, jres = ts.search(tq, packed=True), js.search(jq, packed=True)
    req, forb = ts.compile_where(where)
    pm = ts.predicate_mask(req, forb)
    pred_masks = [pm if q.where else None for q in tq]
    _held(ds, ts, jres, tres, tq, jq, pred_masks=pred_masks)


def test_where_clause_on_sequential_path():
    ds, js, ts = _stores(8, 60, scan=False, pred=True)
    where = (("lacks", "color", "c1"), ("lt", "price", 30.0))
    tq = _queries(ds, tcore.Query, where=where)
    jq = _queries(ds, jcore.Query, where=where)
    tres, jres = ts.search(tq), js.search(jq)
    pm = ts.predicate_mask(*ts.compile_where(where))
    _held(ds, ts, jres, tres, tq, jq,
          pred_masks=[pm if q.where else None for q in tq])


def test_leftover_only_store_routes_batched():
    ds, js, ts = _stores(8, 10 ** 9, scan=True)
    assert not ts.engines and ts.leftover_shard is not None
    tq = _queries(ds, tcore.Query)
    jq = _queries(ds, jcore.Query)
    tres, jres = ts.search(tq), js.search(jq)
    assert {r.path for r in tres} == {"batched+packed"}
    _held(ds, ts, jres, tres, tq, jq)
    small = ts.search(tq[:3])          # below min_packed_batch
    assert {r.path for r in small} == {"batched"}


def test_cpu_store_never_launches_and_counts_stats():
    ds, _, ts = _stores(8, 60, scan=True)
    before = ops.launches
    res = ts.search(_queries(ds, tcore.Query))
    assert ops.launches == before
    assert all(r.stats.indices_visited >= 0 for r in res)
    assert ts.sa() == pytest.approx(_state(8, 60)[1].sa)

"""The port's numpy control plane against the JAX reference package.

Same seeds in, identical outputs out: policies, VEDA / EffVEDA lattices
(node keys, block sets, plans, leftovers, SA), predicate compilation, the
synthetic retrieval dataset, and the state carried across by
``repro_torch.carry``.
"""
import numpy as np
import pytest

from repro import core as jcore
from repro.core.predicate import PredicateSchema as JaxSchema
from repro.data.pipeline import make_retrieval_dataset as jax_dataset
from repro_torch import carry
from repro_torch import core as tcore
from repro_torch.core.predicate import PredicateSchema
from repro_torch.data.pipeline import make_retrieval_dataset


def _same_policy(a, b):
    assert a.n_roles == b.n_roles
    assert list(a.block_roles) == list(b.block_roles)
    assert len(a.block_members) == len(b.block_members)
    for x, y in zip(a.block_members, b.block_members):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def _same_build(a, b):
    assert set(a.lattice.nodes) == set(b.lattice.nodes)
    for key, node in a.lattice.nodes.items():
        assert node.roles == b.lattice.nodes[key].roles
        assert node.blocks == b.lattice.nodes[key].blocks
    assert a.leftovers == b.leftovers
    assert a.plans.keys() == b.plans.keys()
    for r, plan in a.plans.items():
        assert plan.nodes == b.plans[r].nodes
        assert plan.leftover_blocks == b.plans[r].leftover_blocks
    assert a.sa == b.sa


@pytest.mark.parametrize("n,n_roles,n_perm,seed", [
    (500, 4, 8, 0), (2000, 12, 40, 1), (3000, 33, 50, 2), (1500, 64, 80, 3),
])
def test_generate_policy_matches(n, n_roles, n_perm, seed):
    a = jcore.generate_policy(n, n_roles=n_roles, n_permissions=n_perm,
                              seed=seed)
    b = tcore.generate_policy(n, n_roles=n_roles, n_permissions=n_perm,
                              seed=seed)
    _same_policy(a, b)
    np.testing.assert_array_equal(a.role_words(), b.role_words())
    for r in range(n_roles):
        np.testing.assert_array_equal(a.authorized_mask(r),
                                      b.authorized_mask(r))


@pytest.mark.parametrize("builder", ["build_veda", "build_effveda"])
@pytest.mark.parametrize("n_roles,lam,beta,seed", [
    (8, 150, 1.1, 0), (12, 300, 1.3, 1), (40, 100, 1.2, 2),
])
def test_lattice_builders_match(builder, n_roles, lam, beta, seed):
    kw = dict(n_roles=n_roles, n_permissions=n_roles + 20, seed=seed)
    ja = getattr(jcore, builder)(jcore.generate_policy(3000, **kw),
                                 jcore.HNSWCostModel(lam_threshold=lam),
                                 beta=beta, k=10)
    tb = getattr(tcore, builder)(tcore.generate_policy(3000, **kw),
                                 tcore.HNSWCostModel(lam_threshold=lam),
                                 beta=beta, k=10)
    _same_build(ja, tb)
    assert ja.stats == tb.stats


def test_cost_model_matches():
    a = jcore.HNSWCostModel(lam_threshold=2000)
    b = tcore.HNSWCostModel(lam_threshold=2000)
    for n, auth, sel in [(5000, 5000, 1.0), (5000, 700, 1.0),
                         (5000, 700, 0.1), (1000, 10, 1.0), (9000, 0, 1.0)]:
        assert a.role_query_cost(n, auth, 10, selectivity=sel) == \
            b.role_query_cost(n, auth, 10, selectivity=sel)
        assert a.oracle_cost(auth, 10) == b.oracle_cost(auth, 10)
        assert a.indexable(n) == b.indexable(n)


@pytest.mark.parametrize("where", [
    None,
    (("has", "color", "c3"),),
    (("has", "color", "c3"), ("lacks", "color", "c7"), ("ge", "price", 10.0)),
    (("lt", "price", 30.0), ("has", "color", "c39")),
])
def test_compile_where_matches(where):
    tags = {"color": tuple(f"c{i}" for i in range(40))}
    ranges = {"price": (0.0, 10.0, 20.0, 30.0)}
    a = JaxSchema.make(tags=tags, ranges=ranges).compile_where(where)
    b = PredicateSchema.make(tags=tags, ranges=ranges).compile_where(where)
    if where is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    rows = [{"color": "c3", "price": 12.0}, {"color": ["c7", "c39"]}]
    np.testing.assert_array_equal(
        JaxSchema.make(tags=tags, ranges=ranges).encode_rows(rows),
        PredicateSchema.make(tags=tags, ranges=ranges).encode_rows(rows))


def test_unsatisfiable_where_rejected_in_both():
    tags = {"color": ("a", "b")}
    where = (("has", "color", "a"), ("lacks", "color", "a"))
    for schema in (JaxSchema.make(tags=tags), PredicateSchema.make(tags=tags)):
        with pytest.raises(ValueError):
            schema.compile_where(where)


@pytest.mark.parametrize("kw", [
    dict(n_vectors=2000, dim=16, n_roles=8, n_permissions=20, n_queries=30,
         seed=0),
    dict(n_vectors=3000, dim=32, n_roles=32, n_permissions=96, n_queries=40,
         seed=5, sensitivity=0.5, block_zipf=(1.0, 1.5), perm_zipf=(2.0, 1.5)),
])
def test_make_retrieval_dataset_matches(kw):
    a, b = jax_dataset(**kw), make_retrieval_dataset(**kw)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.queries, b.queries)
    np.testing.assert_array_equal(a.query_roles, b.query_roles)
    _same_policy(a.policy, b.policy)
    assert a.dim == b.dim


def test_carry_rebuilds_the_same_state():
    ds = jax_dataset(n_vectors=2500, dim=8, n_roles=10, n_permissions=30,
                     n_queries=12, seed=3)
    res = jcore.build_effveda(ds.policy, jcore.HNSWCostModel(lam_threshold=200),
                              beta=1.1, k=10)
    pol = carry.policy_from_state(ds.policy.n_roles, ds.policy.block_roles,
                                  ds.policy.block_members)
    built = carry.build_result_from_state(
        pol,
        {k: (n.roles, n.blocks) for k, n in res.lattice.nodes.items()},
        {r: (p.nodes, p.leftover_blocks) for r, p in res.plans.items()},
        res.leftovers, res.stats)
    _same_policy(ds.policy, pol)
    _same_build(res, built)
    data = carry.dataset_from_state(ds.vectors, pol, ds.queries,
                                    ds.query_roles)
    np.testing.assert_array_equal(data.vectors, ds.vectors)
    # a merge after carrying never reuses a carried node's key
    lat = built.lattice
    keys = list(lat.nodes)
    assert len(keys) >= 2
    new = lat.merge_into(keys[0], keys[1])
    assert new == keys[1] or new not in keys


@pytest.mark.parametrize("roles,where", [
    (3, None),
    ((5, 1, 5), (("has", "c", "x"), ("has", "c", "x"), ("lt", "p", 1.0))),
    ([2, 0], ()),
])
def test_query_canonical_forms_match(roles, where):
    v = np.arange(4, dtype=np.float64)
    a = jcore.Query(vector=v, roles=roles, k=7, where=where)
    b = tcore.Query(vector=v, roles=roles, k=7, where=where)
    assert a.roles == b.roles and a.where == b.where and a.k == b.k
    assert b.vector.dtype == np.float32
    np.testing.assert_array_equal(a.vector, b.vector)


def test_query_rejects_what_the_reference_rejects():
    v = np.zeros(4, np.float32)
    for bad in (dict(roles=()), dict(roles=(1,), k=0),
                dict(roles=(1,), deadline_ms=0.0)):
        with pytest.raises((AssertionError, ValueError)):
            jcore.Query(vector=v, **bad)
        with pytest.raises(ValueError):
            tcore.Query(vector=v, **bad)


def test_search_stats_merge_and_rates_match():
    kw = dict(impure_visits=4, phase2_skipped=3, efs_used=10.0,
              efs_worst_case=40.0, data_touched=100,
              data_authorized_touched=80)
    a, b = jcore.SearchStats(**kw), tcore.SearchStats(**kw)
    a.merge(jcore.SearchStats(**kw))
    b.merge(tcore.SearchStats(**kw))
    assert (a.skip_rate, a.efs_savings, a.purity) == \
        (b.skip_rate, b.efs_savings, b.purity)

"""The port's ScoreScan engine (device="cpu") against the reference's.

``search_masked_batch``, ``search_masked``, ``lower_bounds`` and
``pack_leftover_shard`` get the same numpy inputs in both packages (the
reference runs its Pallas kernel in interpret mode).  Vectors offset by
1e3 check the centroid centering that keeps the norm trick well
conditioned; scrambled external ids check the local -> external id map.
"""
import numpy as np
import pytest

from repro.ann import scorescan as jscan
from repro.core import generate_policy as jax_policy
from repro_torch.ann import scorescan as tscan
from repro_torch.core import generate_policy
from repro_torch.core.metrics import norm_scale, topk_agreement
from repro_torch.kernels.l2_topk import ops


def _index_pair(n, d, W, offset, seed, P=0):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((n, d)) + offset).astype(np.float32)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)   # scrambled ext ids
    auth = rng.integers(0, 2 ** 16, size=(n, W)).astype(np.uint32)
    if W == 1:
        auth = auth[:, 0]
    attr = None
    if P:
        attr = rng.integers(0, 2 ** 32, size=(n, P), dtype=np.uint64)
        attr = attr.astype(np.uint32)
    j = jscan.ScoreScanIndex(data=data, ids=ids, auth_bits=auth,
                             attr_bits=attr)
    t = tscan.ScoreScanIndex(data=data, ids=ids, auth_bits=auth,
                             attr_bits=attr, device="cpu")
    return rng, data, j, t


def _role_rows(rng, b, W):
    rows = np.zeros((b, W), np.uint32)
    for row in range(b):
        rows[row, rng.integers(W)] = np.uint32(1) << np.uint32(
            rng.integers(16))
    return rows[:, 0] if W == 1 else rows


@pytest.mark.parametrize("n,d,W,offset,k", [
    (700, 16, 1, 0.0, 10),
    (900, 24, 2, 1e3, 8),       # far from the origin: centering matters
    (300, 8, 3, 1e3, 25),
])
def test_search_masked_batch_matches_reference(n, d, W, offset, k):
    rng, data, j, t = _index_pair(n, d, W, offset, seed=n)
    qs = (rng.standard_normal((6, d)) + offset).astype(np.float32)
    roles = _role_rows(rng, 6, W)
    jd, ji = j.search_masked_batch(qs, k, roles)
    td, ti = t.search_masked_batch(qs, k, roles)
    assert td.shape == (6, k) and ti.dtype == np.int64
    scale = norm_scale(qs - j.centroid, data - j.centroid)
    res = topk_agreement(td, ti, jd, ji, scale)
    assert res["ok"], res
    # every returned id is an external id of an authorized row
    auth = t.auth_bits.reshape(n, -1)
    pos = {int(e): p for p, e in enumerate(t.ids)}
    for row, ext in zip(np.atleast_2d(roles.reshape(6, -1)), ti):
        for e in ext[ext >= 0]:
            assert (auth[pos[int(e)]] & row).any()
    np.testing.assert_allclose(t.lower_bounds(qs), j.lower_bounds(qs),
                               rtol=1e-6)
    assert t.radius == j.radius
    np.testing.assert_array_equal(t.centroid, j.centroid)


def test_bounds_and_predicates_match_reference():
    rng, data, j, t = _index_pair(800, 16, 1, 0.0, seed=4, P=2)
    qs = rng.standard_normal((5, 16)).astype(np.float32)
    roles = _role_rows(rng, 5, 1)
    req = np.zeros((5, 2), np.uint32)
    req[:, 1] = 1 << 4
    forb = np.zeros((5, 2), np.uint32)
    forb[:, 0] = 1 << 9
    jd0, _ = j.search_masked_batch(qs, 10, roles, require=req, forbid=forb)
    bounds = np.where(np.isfinite(jd0[:, 4]), jd0[:, 4] + 1e-3, np.inf)
    bounds = bounds.astype(np.float32)
    jd, ji = j.search_masked_batch(qs, 10, roles, bounds=bounds,
                                   require=req, forbid=forb)
    td, ti = t.search_masked_batch(qs, 10, roles, bounds=bounds,
                                   require=req, forbid=forb)
    res = topk_agreement(td, ti, jd, ji, norm_scale(qs, data))
    assert res["ok"], res
    assert ((ti >= 0).sum(axis=1) <= 5).all()


def test_single_query_search_masked_matches_reference():
    rng, data, j, t = _index_pair(500, 8, 2, 1e3, seed=7)
    q = (rng.standard_normal(8) + 1e3).astype(np.float32)
    mask = np.array([0xFFFF, 0], np.uint32)
    a = j.search_masked(q, 7, mask)
    b = t.search_masked(q, 7, mask)
    assert [i for _, i in a] == [i for _, i in b]
    np.testing.assert_allclose([d for d, _ in a], [d for d, _ in b],
                               rtol=1e-5, atol=1e-2)


def test_cpu_index_never_launches_the_kernel():
    rng, _, _, t = _index_pair(200, 8, 1, 0.0, seed=8)
    before = ops.launches
    t.search_masked_batch(rng.standard_normal((3, 8)).astype(np.float32), 5,
                          np.full(3, 0xFFFF, np.uint32))
    assert ops.launches == before
    assert t._db.device.type == "cpu" and t._auth.shape == (1, 200)


@pytest.mark.parametrize("n_roles", [12, 40])
def test_pack_leftover_shard_matches_reference(n_roles):
    kw = dict(n_roles=n_roles, n_permissions=n_roles + 10, seed=2)
    jp, tp = jax_policy(1200, **kw), generate_policy(1200, **kw)
    rng = np.random.default_rng(n_roles)
    data = rng.standard_normal((1200, 8)).astype(np.float32)
    blocks = [b for b in range(jp.n_blocks) if jp.block_size(b) < 40]
    lv = {b: data[jp.block_members[b]] for b in blocks}
    li = {b: jp.block_members[b] for b in blocks}
    js = jscan.pack_leftover_shard(lv, li, jp)
    ts = tscan.pack_leftover_shard(lv, li, tp, device="cpu")
    np.testing.assert_array_equal(js.ids, ts.ids)
    np.testing.assert_array_equal(js.auth_bits, ts.auth_bits)
    np.testing.assert_array_equal(js.data, ts.data)
    assert ts.mask_width == js.mask_width
    qs = rng.standard_normal((4, 8)).astype(np.float32)
    w = ts.mask_width
    roles = np.stack([tp.role_words()[0] if w > 1 else tp.role_words()[0, :1]
                      for _ in range(4)])
    roles = roles[:, 0] if w == 1 else roles
    jd, ji = js.search_masked_batch(qs, 10, roles)
    td, ti = ts.search_masked_batch(qs, 10, roles)
    res = topk_agreement(td, ti, jd, ji, norm_scale(qs, data))
    assert res["ok"], res
    assert tscan.pack_leftover_shard({}, {}, tp, device="cpu") is None


def test_factory_builds_cpu_engines_with_policy_words():
    policy = generate_policy(600, n_roles=40, n_permissions=50, seed=1)
    make = tscan.scorescan_factory(policy, device="cpu")
    ids = np.arange(0, 600, 3, dtype=np.int64)
    eng = make(np.zeros((len(ids), 4), np.float32), ids)
    np.testing.assert_array_equal(eng.auth_bits, policy.role_words()[ids])
    assert eng.mask_width == 2 and eng._auth.shape == (2, len(ids))

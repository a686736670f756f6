"""Port's l2_topk (plain version and CPU dispatch) vs the JAX reference.

The same numpy inputs go to ``repro.kernels.l2_topk.l2_topk_ref`` and to the
port's ``l2_topk_ref`` and ``ops.l2_topk`` on CPU tensors, on the shape grid
of tests/test_kernels_l2topk.py cut to N <= 4000, d <= 32, B <= 16.  Results
are held to each other by the port's parity rule
(``repro_torch.core.metrics.topk_agreement``).  One case runs the
reference's Pallas kernel body in interpret mode.  The Hopper kernel
itself is held to the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.l2_topk import L2TopKConfig as JaxConfig
from repro.kernels.l2_topk import l2_topk as jax_l2_topk
from repro.kernels.l2_topk import l2_topk_ref as jax_ref
from repro_torch.core.metrics import norm_scale, topk_agreement
from repro_torch.kernels.l2_topk import kernel, l2_topk_ref, ops


_jax_ref = jax.jit(jax_ref, static_argnums=(5,))


def _jax(q, db, auth, mask, bound, k, **pk):
    d, i = _jax_ref(jnp.array(q), jnp.array(db), jnp.array(auth),
                   jnp.asarray(mask, jnp.uint32),
                   jnp.asarray(np.inf if bound is None else bound,
                               jnp.float32), k, **pk)
    return np.array(d), np.array(i)


def _port_ref(q, db, auth, mask, bound, k, **pk):
    d, i = l2_topk_ref(torch.from_numpy(q), torch.from_numpy(db), auth, mask,
                       np.inf if bound is None else bound, k, **pk)
    return d.numpy(), i.numpy()


def _port_ops(q, db, auth, mask, bound, k, **pk):
    before = ops.launches
    d, i = ops.l2_topk(torch.from_numpy(q), torch.from_numpy(db), auth, mask,
                       k, bound=bound, **pk)
    assert ops.launches == before          # CPU tensors never launch
    return d.numpy(), i.numpy()


def _check(q, db, auth, mask, k, bound=None, **pk):
    """All three agree under the parity rule; returns the port's ops ids."""
    jd, ji = _jax(q, db, auth, mask, bound, k, **pk)
    scale = norm_scale(q, db)
    for fn in (_port_ref, _port_ops):
        d, i = fn(q, db, auth, mask, bound, k, **pk)
        assert d.shape == (len(q), k) and i.shape == (len(q), k)
        assert d.dtype == np.float32 and i.dtype == np.int32
        res = topk_agreement(d, i, jd[:, :k], ji[:, :k], scale)
        assert res["ok"], (fn.__name__, res)
    return i


def _data(B, N, d, seed):
    rng = np.random.default_rng(seed)
    return (rng, rng.standard_normal((B, d)).astype(np.float32),
            rng.standard_normal((N, d)).astype(np.float32))


def _word_mask(roles, W):
    out = np.zeros(W, np.uint32)
    for r in roles:
        out[r // 32] |= np.uint32(1) << np.uint32(r % 32)
    return out


@pytest.mark.parametrize("B,N,d,k", [
    (1, 100, 8, 1),
    (3, 513, 17, 5),        # unaligned everything
    (8, 2048, 32, 10),
    (5, 1000, 32, 32),
    (2, 4000, 32, 10),
    (16, 700, 24, 128),     # k at the kernel's limit
])
def test_single_word_matches_reference(B, N, d, k):
    rng, q, db = _data(B, N, d, 0)
    auth = rng.integers(0, 2 ** 16, size=N).astype(np.uint32)
    _check(q, db, auth, np.uint32(1 << 3), k)


def test_bound_pruning_matches_reference():
    rng, q, db = _data(4, 600, 24, 0)
    auth = rng.integers(0, 2 ** 16, size=600).astype(np.uint32)
    jd, _ = _jax(q, db, auth, np.uint32(8), None, 8)
    bound = float((jd[0, 3] + jd[0, 4]) / 2)     # midpoint: no float ties
    ids = _check(q, db, auth, np.uint32(8), 8, bound=bound)
    assert (ids[0] >= 0).sum() == 4


def test_per_query_role_masks_and_bounds():
    rng, q, db = _data(6, 700, 24, 6)
    auth = rng.integers(0, 2 ** 8, size=700).astype(np.uint32)
    masks = np.uint32(1) << rng.integers(0, 8, size=6).astype(np.uint32)
    jd, _ = _jax(q, db, auth, masks, None, 8)
    bounds = np.full(6, np.inf, np.float32)
    for row in range(1, 6):
        bounds[row] = (jd[row, row] + jd[row, row + 1]) / 2
    ids = _check(q, db, auth, masks, 8, bound=bounds)
    for row in range(1, 6):
        assert (ids[row] >= 0).sum() == row + 1
    for row, m in zip(ids, masks):
        assert all(auth[v] & m for v in row[row >= 0])


def test_vector_args_equal_scalar_args():
    rng, q, db = _data(5, 300, 16, 8)
    auth = rng.integers(0, 2 ** 8, size=300).astype(np.uint32)
    ds, is_ = _port_ops(q, db, auth, np.uint32(4), 9.0, 6)
    dv, iv = _port_ops(q, db, auth, np.full(5, 4, np.uint32),
                       np.full(5, 9.0, np.float32), 6)
    assert (is_ == iv).all() and (ds == dv).all()


def test_no_authorized_vectors_gives_empty():
    _, q, db = _data(2, 64, 16, 3)
    d, i = _port_ops(q, db, np.zeros(64, np.uint32), np.uint32(1), None, 5)
    assert (i == -1).all() and np.isinf(d).all()
    _check(q, db, np.zeros(64, np.uint32), np.uint32(1), 5)


def test_k_larger_than_authorized():
    _, q, db = _data(3, 200, 8, 9)
    auth = np.zeros(200, np.uint32)
    auth[:3] = 1
    auth[3:8] |= 2
    masks = np.array([1, 2, 4], np.uint32)       # row 2 matches nothing
    i = _check(q, db, auth, masks, 10)
    assert (i[0] >= 0).sum() == 3 and set(i[0][:3]) <= {0, 1, 2}
    assert (i[1] >= 0).sum() == 5 and set(i[1][:5]) <= {3, 4, 5, 6, 7}
    assert (i[2] == -1).all()


@pytest.mark.parametrize("B,N,d,k,W", [
    (3, 513, 17, 5, 2),      # 64-role universe, unaligned
    (6, 700, 24, 8, 2),
    (5, 300, 16, 6, 8),      # 256-role universe
    (1, 100, 8, 1, 3),
])
def test_multi_word_matches_reference(B, N, d, k, W):
    rng, q, db = _data(B, N, d, 0)
    auth = rng.integers(0, 2 ** 16, size=(N, W)).astype(np.uint32)
    masks = np.stack([_word_mask([r], W)
                      for r in rng.integers(0, 32 * W, size=B)])
    ids = _check(q, db, auth, masks, k)
    for row, m in zip(ids, masks):
        assert all((auth[v] & m).any() for v in row[row >= 0])


def test_shared_multi_word_mask():
    rng, q, db = _data(4, 500, 16, 11)
    auth = rng.integers(0, 2 ** 16, size=(500, 2)).astype(np.uint32)
    _check(q, db, auth, _word_mask([5, 40], 2), 7)


def test_word_boundary_roles_do_not_alias():
    roles = [1, 31, 32, 33, 63, 64]
    W = 3
    rng, q, db = _data(len(roles), 300, 8, 22)
    vec_roles = np.asarray(roles)[rng.integers(0, len(roles), size=300)]
    auth = np.stack([_word_mask([r], W) for r in vec_roles])
    masks = np.stack([_word_mask([r], W) for r in roles])
    ids = _check(q, db, auth, masks, 10)
    for row, r in zip(ids, roles):
        got = row[row >= 0]
        assert len(got) and (vec_roles[got] == r).all()


def test_scalar_mask_rejected_for_multi_word_auth():
    _, q, db = _data(2, 64, 8, 23)
    with pytest.raises(ValueError):
        ops.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                    np.ones((64, 2), np.uint32), np.uint32(1), 5)


def test_predicate_rows_without_attr_plane_rejected():
    _, q, db = _data(2, 64, 8, 24)
    with pytest.raises(ValueError):
        ops.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                    np.ones(64, np.uint32), np.uint32(1), 5,
                    require=np.ones(1, np.uint32))


@pytest.mark.parametrize("B,N,d,k,P", [
    (3, 513, 17, 5, 1),
    (6, 700, 24, 8, 2),
    (1, 100, 8, 1, 2),
])
def test_predicate_plane_matches_reference(B, N, d, k, P):
    rng, q, db = _data(B, N, d, 0)
    auth = rng.integers(1, 2 ** 16, size=N).astype(np.uint32)
    attr = rng.integers(0, 2 ** 32, size=(N, P), dtype=np.uint64)
    req = np.zeros((B, P), np.uint32)
    forb = np.zeros((B, P), np.uint32)
    for row in range(B):
        req[row, rng.integers(0, P)] |= np.uint32(1 << int(rng.integers(32)))
        forb[row, rng.integers(0, P)] |= np.uint32(1 << int(rng.integers(32)))
    forb &= ~req
    pk = dict(attr_bits=attr.astype(np.uint32), require=req, forbid=forb)
    ids = _check(q, db, auth, np.uint32(1 << 3), k, **pk)
    a = pk["attr_bits"]
    for row, hits in enumerate(ids):
        for v in hits[hits >= 0]:
            assert ((a[v] & req[row]) == req[row]).all()
            assert not (a[v] & forb[row]).any()


def test_shared_predicate_rows_and_k_beyond_rows():
    """(P,) shared require row; k above N pads with +inf / -1."""
    rng, q, db = _data(3, 20, 8, 25)
    auth = np.ones(20, np.uint32)
    attr = rng.integers(0, 4, size=(20, 1)).astype(np.uint32)
    d, i = _port_ops(q, db, auth, np.uint32(1), None, 32, attr_bits=attr,
                     require=np.array([1], np.uint32))
    n_pass = int((attr[:, 0] & 1).sum())
    assert ((i >= 0).sum(axis=1) == n_pass).all()
    assert np.isinf(d[:, n_pass:]).all() and (i[:, n_pass:] == -1).all()


def test_plain_version_matches_pallas_kernel_body():
    """The reference's Pallas kernel, run in interpret mode, against the
    port's CPU path on the same inputs."""
    rng, q, db = _data(8, 512, 16, 30)
    auth = rng.integers(0, 2 ** 16, size=(512, 2)).astype(np.uint32)
    masks = np.stack([_word_mask([r], 2)
                      for r in rng.integers(0, 64, size=8)])
    jd, ji = jax_l2_topk(jnp.array(q), jnp.array(db), jnp.array(auth),
                         masks, 10, config=JaxConfig(interpret=True))
    d, i = _port_ops(q, db, auth, masks, None, 10)
    res = topk_agreement(d, i, np.array(jd), np.array(ji), norm_scale(q, db))
    assert res["ok"], res


def test_word_operands_keep_their_bits():
    """uint32 words past 2**31 survive the int32 view both ways."""
    rng, q, db = _data(2, 50, 8, 31)
    auth = np.full(50, 0x80000000, np.uint32)
    auth[::2] = 0x00000001
    i = _check(q, db, auth, np.uint32(0x80000000), 50)
    assert set(i[i >= 0]) == set(range(1, 50, 2))


def test_k_outside_limits_raises():
    _, q, db = _data(1, 10, 4, 32)
    for k in (0, kernel.MAX_K + 1):
        with pytest.raises(ValueError):
            ops.l2_topk(torch.from_numpy(q), torch.from_numpy(db),
                        np.ones(10, np.uint32), np.uint32(1), k)


def test_non_cpu_tensors_go_to_the_kernel_and_never_fall_back():
    """A tensor off the CPU takes the kernel path, which checks its
    operands and raises; the plain version is never tried."""
    q = torch.empty((2, 8), device="meta")
    db = torch.empty((16, 8), device="meta")
    aw = torch.empty((1, 16), dtype=torch.int32, device="meta")
    rows = torch.empty((2, 1), dtype=torch.int32, device="meta")
    bounds = torch.empty((2,), device="meta")
    before = ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.l2_topk_words(q, db, aw, rows, bounds, 5)
    assert ops.launches == before


def test_cuda_default_raises_without_a_card(monkeypatch):
    from repro_torch.ann.scorescan import scorescan_factory
    from repro_torch.core import generate_policy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policy = generate_policy(50, n_roles=4, n_permissions=6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        scorescan_factory(policy)
    with pytest.raises(RuntimeError, match="CUDA"):
        scorescan_factory(policy, device="cuda")


def test_store_defaults_to_card_engines(monkeypatch):
    """``build_vector_storage`` with no factory builds ScoreScan engines on
    the card: it raises without one, and gives the CPU only when asked."""
    from repro_torch.core import (HNSWCostModel, build_effveda,
                                  build_vector_storage)
    from repro_torch.data.pipeline import make_retrieval_dataset
    ds = make_retrieval_dataset(n_vectors=400, dim=8, n_roles=4,
                                n_permissions=6, n_queries=4, seed=0)
    res = build_effveda(ds.policy, HNSWCostModel(lam_threshold=40), k=5)
    store = build_vector_storage(res, ds.vectors, device="cpu")
    assert store.batched_capable()
    assert all(e.device.type == "cpu" for e in store.engines.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_vector_storage(res, ds.vectors)


@pytest.mark.parametrize("b,n", [(1, 1), (1, 258_879), (7, 1000),
                                 (64, 258_879), (64, 27_820), (200, 5000)])
def test_split_rows_cover_every_row_once(b, n):
    s, chunk = kernel.split_rows(b, n, 132)
    assert 1 <= s <= kernel.MAX_SPLITS and chunk % kernel.ROW_TILE == 0
    assert (s - 1) * chunk < n <= s * chunk      # no empty split

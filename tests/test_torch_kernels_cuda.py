"""Card-only tests of the port: the Hopper ``l2_topk`` and flash attention
kernels against their plain PyTorch versions, a small store searched on the
card against the same store on the CPU, and the RAG serve path launching
the attention kernel in every layer of prefill and decode.

The kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card.  The file imports no JAX, so it runs on a machine
that has only PyTorch (``--noconftest``: tests/conftest.py imports the
reference package):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.ann.scorescan import scorescan_factory
from repro_torch.core import (HNSWCostModel, Query, build_effveda,
                              build_vector_storage)
from repro_torch.core.metrics import norm_scale, topk_agreement
from repro_torch.data.pipeline import make_retrieval_dataset
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.l2_topk import l2_topk_ref, ops
from repro_torch.launch.serve import build_demo_server

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _word_mask(roles, W):
    out = np.zeros(W, np.uint32)
    for r in roles:
        out[r // 32] |= np.uint32(1) << np.uint32(r % 32)
    return out


@pytest.mark.parametrize("B,N,d,k,W,P", [
    (1, 1, 16, 1, 1, 0),
    (7, 1000, 17, 10, 2, 0),        # d % 4 != 0: scalar staging path
    (64, 5000, 128, 128, 8, 2),
    (20, 3000, 32, 5, 1, 1),        # two query tiles
])
def test_kernel_matches_plain_version(card, B, N, d, k, W, P):
    rng = np.random.default_rng(40)
    q = rng.standard_normal((B, d)).astype(np.float32)
    db = rng.standard_normal((N, d)).astype(np.float32)
    auth = rng.integers(0, 2 ** 16, size=(N, W)).astype(np.uint32)
    masks = np.stack([_word_mask([r], W)
                      for r in rng.integers(0, 16 * W, size=B)])
    pk = {}
    if P:
        attr = rng.integers(0, 2 ** 32, size=(N, P), dtype=np.uint64)
        pk = dict(attr_bits=attr.astype(np.uint32),
                  forbid=np.full((B, P), 1, np.uint32))
    qt, dbt = torch.from_numpy(q).to(card), torch.from_numpy(db).to(card)
    before = ops.launches
    d_, i_ = ops.l2_topk(qt, dbt, auth, masks, k, **pk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    rd, ri = l2_topk_ref(qt, dbt, auth, masks, np.inf, k, **pk)
    res = topk_agreement(d_.cpu().numpy(), i_.cpu().numpy(),
                         rd.cpu().numpy(), ri.cpu().numpy(), norm_scale(q, db))
    assert res["ok"], res


def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((2, 8), device=card)
    db = torch.zeros((16, 8), device=card)
    with pytest.raises(ValueError):      # nine auth words
        ops.l2_topk(q, db, np.ones((16, 9), np.uint32),
                    np.ones((2, 9), np.uint32), 5)
    with pytest.raises(ValueError):      # db left on the CPU
        ops.l2_topk_words(q, db.cpu(), torch.ones((1, 16), dtype=torch.int32,
                                                  device=card),
                          torch.ones((2, 1), dtype=torch.int32, device=card),
                          torch.full((2,), float("inf"), device=card), 5)


def test_store_on_the_card_matches_store_on_the_cpu(card):
    ds = make_retrieval_dataset(n_vectors=6000, dim=32, n_roles=40,
                                n_permissions=60, n_queries=48, seed=1)
    res = build_effveda(ds.policy, HNSWCostModel(lam_threshold=300), k=10)
    queries = [Query(vector=v, roles=(int(r),), k=10)
               for v, r in zip(ds.queries, ds.query_roles)]
    out = {}
    for dev in ("cpu", "cuda"):
        store = build_vector_storage(
            res, ds.vectors,
            engine_factory=scorescan_factory(ds.policy, device=dev),
            pack_leftovers=True, device=dev)
        before = ops.launches
        out[dev] = store.search(queries)
        assert (ops.launches > before) == (dev == "cuda")
    for q, a, b in zip(queries, out["cpu"], out["cuda"]):
        assert b.path == "batched+packed"
        pad = [np.inf] * (10 - len(a)), [-1] * (10 - len(a))
        res = topk_agreement(
            np.array([b.dists + pad[0]]), np.array([b.ids + pad[1]]),
            np.array([a.dists + pad[0]]), np.array([a.ids + pad[1]]),
            norm_scale(q.vector[None], ds.vectors))
        assert len(a) == len(b) and res["ok"], res


# (B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, kv_len)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 32, True, 0, 128),
    (1, 2, 2, 100, 100, 64, True, 0, 100),
    (1, 4, 1, 1, 256, 32, False, 255, 200),
    (2, 2, 2, 64, 192, 16, True, 128, 192),
    (1, 8, 8, 256, 256, 128, True, 0, 256),
    (1, 3, 1, 37, 75, 20, True, 38, 75),
    (1, 3, 1, 33, 41, 64, True, 0, 33),       # prefill into a longer cache
    (2, 6, 2, 20, 80, 16, True, 30, 50),      # a chunk at an offset
    (2, 15, 5, 1, 1033, 64, True, 1020, 1021),  # decode, SmolLM heads
    (2, 15, 5, 1, 8, 64, True, 0, 0),         # nothing valid: zeros
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(card, case, dtype):
    """f32: rtol 2e-4, atol 2e-5 (the reference's kernel test tolerance;
    both sum in f32 in another order).  bf16: the same bf16 inputs on both
    sides, f32 math in both, so the same tolerance holds."""
    B, Hq, Hkv, Sq, Sk, hd, causal, off, kv_len = case
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype)
        for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                                    kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, Sq, Hq, hd)
    ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off,
                              kv_len=kv_len)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)


def test_flash_kernel_reads_a_cache_slab_in_place(card):
    """Layer i's slab of an (L, B, Smax, Hkv, hd) cache, and q as a strided
    view: no copy is needed and the answer is the contiguous one."""
    rng = np.random.default_rng(42)
    cache = torch.from_numpy(rng.standard_normal((3, 2, 50, 5, 64)).astype(
        np.float32)).to(card)
    qfull = torch.from_numpy(rng.standard_normal((2, 9, 30, 64)).astype(
        np.float32)).to(card)
    q = qfull[:, :, ::2]                     # (2, 9, 15, 64), head stride 128
    k, v = cache[1], cache[2]
    out = flash_ops.flash_attention(q, k, v, causal=True, q_offset=20,
                                    kv_len=29)
    ref = flash_attention_ref(q.contiguous(), k, v, causal=True,
                              q_offset=20, kv_len=29)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 4, 16), device=card)
    kv = torch.zeros((1, 8, 2, 16), device=card)
    with pytest.raises(TypeError):           # mixed dtypes
        flash_ops.flash_attention(q, kv.bfloat16(), kv.bfloat16(),
                                  causal=True, q_offset=0, kv_len=2)
    with pytest.raises(ValueError):          # head dim above 128
        big = torch.zeros((1, 2, 2, 160), device=card)
        flash_ops.flash_attention(big, big, big, causal=True, q_offset=0,
                                  kv_len=2)
    with pytest.raises(ValueError):          # k left on the CPU
        flash_ops.flash_attention(q, kv.cpu(), kv, causal=True, q_offset=0,
                                  kv_len=2)


def test_serve_batch_launches_attention_in_every_layer(card):
    server, ds = build_demo_server(n_vectors=1500, dim=16, n_roles=6)
    ops.launches = flash_ops.launches = 0
    out = server.serve_batch(ds.queries[:4], ds.query_roles[:4], k=3,
                             decode_tokens=5)
    assert flash_ops.launches == server.cfg.n_layers * (1 + 5)
    assert ops.launches > 0
    assert out["tokens"].shape == (4, 5)
    for r, pids in zip(ds.query_roles[:4], out["retrieved"]):
        assert ds.policy.authorized_mask(int(r))[pids].all()

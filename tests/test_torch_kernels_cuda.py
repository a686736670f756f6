"""Card-only tests of the port: the Hopper ``l2_topk`` kernel against its
plain PyTorch version, and a small store searched on the card against the
same store on the CPU.

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
from repro_torch.kernels.l2_topk import l2_topk_ref, ops

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

"""The slice end to end: the port's ``RAGServer.serve_batch`` against the
reference's, on the CPU.

The reference builds the corpus, the EffVEDA lattice and the smoke LM's
parameters; ``carry`` hands the build and the parameters to the port, so
both servers retrieve from the same lattice over the same rows and generate
with the same weights (f32 smoke configuration of SmolLM-360M).  Retrieved
ids must be equal, and the generated tokens equal one for one.
"""
import functools

import jax
import numpy as np
import pytest

from repro import core as jcore
from repro.ann.scorescan import scorescan_factory as jax_scorescan
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import make_retrieval_dataset
from repro.launch.serve import RAGServer as JaxServer
from repro.models.model import init_params as jax_init_params
from repro_torch import carry
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_vector_storage
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch.serve import RAGServer, build_demo_server

ARCH = "smollm-360m"


@functools.lru_cache(maxsize=None)
def _servers(passage_tokens=8):
    """The reference's server and the port's, on one build and one set of
    parameters (built once per process: the reference jit-compiles)."""
    ds = make_retrieval_dataset(n_vectors=4000, dim=24, n_roles=8,
                                n_permissions=24, seed=0)
    res = jcore.build_effveda(ds.policy,
                              jcore.HNSWCostModel(lam_threshold=400),
                              beta=1.1, k=10)
    js = jcore.build_vector_storage(
        res, ds.vectors, engine_factory=jax_scorescan(ds.policy),
        pack_leftovers=True)
    jp = jax_init_params(jax_smoke(ARCH), jax.random.PRNGKey(0))
    jserver = JaxServer(cfg=jax_smoke(ARCH), params=jp, store=js,
                        passage_tokens=passage_tokens)

    pol = carry.policy_from_state(ds.policy.n_roles, ds.policy.block_roles,
                                  ds.policy.block_members)
    tres = carry.build_result_from_state(
        pol, {k: (v.roles, v.blocks) for k, v in res.lattice.nodes.items()},
        {r: (p.nodes, p.leftover_blocks) for r, p in res.plans.items()},
        res.leftovers, res.stats)
    ts = build_vector_storage(tres, ds.vectors, pack_leftovers=True,
                              device="cpu")
    cfg = get_smoke_config(ARCH)
    tp = carry.params_from_state(cfg, jax.tree.map(np.asarray, jp), "cpu")
    tserver = RAGServer(cfg=cfg, params=tp, store=ts,
                        passage_tokens=passage_tokens, device="cpu")
    return ds, jserver, tserver


@pytest.mark.parametrize("batch,k,decode_tokens", [(6, 4, 8), (3, 10, 3)])
def test_serve_batch_matches_reference(batch, k, decode_tokens):
    ds, jserver, tserver = _servers()
    qs, roles = ds.queries[:batch], ds.query_roles[:batch]
    want = jserver.serve_batch(qs, roles, k=k, decode_tokens=decode_tokens)
    got = tserver.serve_batch(qs, roles, k=k, decode_tokens=decode_tokens)
    assert got["retrieved"] == want["retrieved"]
    assert got["tokens"].shape == (batch, decode_tokens)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for r, pids in zip(roles, got["retrieved"]):
        assert len(pids) == k
        assert ds.policy.authorized_mask(int(r))[pids].all()


def test_serve_batch_runs_attention_through_the_wrapper(monkeypatch):
    """Every attention layer of prefill and of each decode step goes
    through ``ops.flash_attention``: n_layers x (1 + decode_tokens) calls.
    (On the CPU the wrapper takes the plain version and counts no launch;
    the card test counts the kernel's launches.)"""
    ds, _, tserver = _servers()
    calls = []
    inner = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw["q_offset"], kw["kv_len"], k.shape[1]))
        return inner(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    before = ops.launches
    tserver.serve_batch(ds.queries[:2], ds.query_roles[:2], k=4,
                        decode_tokens=5)
    n_layers, prompt = tserver.cfg.n_layers, 4 * 8 + 1
    assert len(calls) == n_layers * (1 + 5)
    assert ops.launches == before
    # prefill into the full cache at offset 0, then one row per step
    assert calls[:n_layers] == [(prompt, 0, prompt, prompt + 5)] * n_layers
    for t in range(5):
        step = calls[n_layers * (1 + t):n_layers * (2 + t)]
        assert step == [(1, prompt + t, prompt + t + 1, prompt + 5)] * n_layers


@pytest.mark.parametrize("engine", ["scorescan", "exact"])
def test_demo_server_on_the_cpu_serves_authorized_passages(engine):
    server, ds = build_demo_server(n_vectors=1500, dim=16, n_roles=6,
                                   engine=engine, device="cpu")
    assert server.batched_capable() == (engine == "scorescan")
    out = server.serve_batch(ds.queries[:4], ds.query_roles[:4], k=3,
                             decode_tokens=2)
    assert out["tokens"].shape == (4, 2)
    assert ((out["tokens"] >= 0) & (out["tokens"] < server.cfg.vocab_size)
            ).all()
    for r, pids in zip(ds.query_roles[:4], out["retrieved"]):
        assert ds.policy.authorized_mask(int(r))[pids].all()

"""The port's generator LM (``repro_torch.models``) against the reference's.

Both packages run SmolLM-360M's smoke configuration (2 layers, d_model 64,
4 query heads over 2 kv heads, vocab 256) on the same parameters: the
reference's ``init_params`` draws them and ``carry.params_from_state``
hands them to the port.  Activations come from a seeded numpy generator.
In f32 every layer and the serve steps hold to ``rtol=1e-4, atol=1e-4``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.sharding import NO_RULES
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import carry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import RAGServer, build_demo_server
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCH = "smollm-360m"
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)


def _jax_cfg(dtype="float32"):
    return dataclasses.replace(jax_smoke(ARCH), dtype=dtype)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(dtype="float32", seed=0):
    """The reference's parameters, and the port's copy of them."""
    jp = JM.init_params(_jax_cfg(dtype), jax.random.PRNGKey(seed))
    return jp, carry.params_from_state(_cfg(dtype), _numpy_tree(jp), "cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ours = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    ref = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.hd, ours.padded_vocab, ours.param_count()) == \
        (ref.hd, ref.padded_vocab, ref.param_count())


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(TL.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               _np(JL.rms_norm(x, w, 1e-6)), **TOL)
    xh = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(TL.rope(_t(xh), _t(pos), 1e4).numpy(),
                               _np(JL.rope(xh, pos, 1e4)), **TOL)


def test_mlp_matches_reference():
    jp, tp = _params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = JL.mlp_apply(jax.tree.map(lambda a: a[0], jp["layers"]["mlp"]),
                        jnp.asarray(x), NO_RULES)
    got = TL.mlp_apply(tp["layers"][0]["mlp"], _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_attention_matches_reference_with_and_without_cache():
    cfg, jcfg = _cfg(), _jax_cfg()
    jp, tp = _params()
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = tp["layers"][0]["attn"]
    rng = np.random.default_rng(2)
    s, smax = 7, 12
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want, _ = JL.attention_apply(ja, jnp.asarray(x), jcfg, NO_RULES,
                                 jnp.asarray(pos))
    got, none = TL.attention_apply(ta, _t(x), cfg, _t(pos))
    assert none is None
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    # into a longer cache: the prompt, then one step at cache_pos = s
    shape = (2, smax, cfg.n_kv_heads, cfg.hd)
    jc = (jnp.zeros(shape), jnp.zeros(shape))
    tc = (torch.zeros(shape), torch.zeros(shape))
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    for xs, cpos in ((x, 0), (x1, s)):
        p = np.broadcast_to(cpos + np.arange(xs.shape[1], dtype=np.int32),
                            xs.shape[:2])
        want, jc = JL.attention_apply(ja, jnp.asarray(xs), jcfg, NO_RULES,
                                      jnp.asarray(p), cache=jc,
                                      cache_pos=jnp.int32(cpos))
        got, tc = TL.attention_apply(ta, _t(xs), cfg, _t(p), cache=tc,
                                     cache_pos=cpos)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def _serve_steps(dtype, steps=4, b=2, prompt=9, seed=3):
    """Prefill then ``steps`` teacher-forced decode steps in both packages;
    returns the pairs of logits and the pairs of final caches."""
    cfg, jcfg = _cfg(dtype), _jax_cfg(dtype)
    jp, tp = _params(dtype)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, prompt + steps)).astype(
        np.int32)
    max_seq = prompt + steps
    jcache = JM.init_cache(jcfg, b, max_seq, dtype=JL._dtype(jcfg))
    tcache = TM.init_cache(cfg, b, max_seq, device="cpu")
    jl, jcache = JM.prefill_fn(jp, jcfg, NO_RULES,
                               tokens=jnp.asarray(toks[:, :prompt]),
                               cache=jcache)
    tl, tcache = TM.prefill_fn(tp, cfg, _t(toks[:, :prompt]), tcache)
    logits = [(tl, jl)]
    for t in range(steps):
        tok = toks[:, prompt + t:prompt + t + 1]
        jl, jcache = JM.decode_fn(jp, jcfg, NO_RULES, jnp.asarray(tok),
                                  jcache, jnp.int32(prompt + t))
        tl, tcache = TM.decode_fn(tp, cfg, _t(tok), tcache, prompt + t)
        logits.append((tl, jl))
    return logits, (tcache, jcache)


def test_prefill_and_decode_match_reference_f32():
    logits, (tcache, jcache) = _serve_steps("float32")
    for tl, jl in logits:
        assert tl.shape == (2, 256) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]),
                                   **TOL)


def test_prefill_and_decode_match_reference_bf16():
    """bf16 parameters, activations and cache.  Both packages round every
    projection, norm and attention output to bf16 (8 bits of mantissa, a
    relative step of 2**-8), but at different places inside each op, so a
    rounding can differ by one step and carry through the two layers.  The
    logits reach about 3, where one bf16 step is 2**-6; they hold to 0.05
    absolute, three such steps (two were seen), and greedy tokens agree
    wherever the reference's top two logits are further apart than 0.1."""
    logits, _ = _serve_steps("bfloat16")
    for tl, jl in logits:
        assert tl.dtype == torch.bfloat16
        a, b = tl.float().numpy(), _np(jl)
        assert np.abs(a - b).max() < 0.05, np.abs(a - b).max()
        top2 = np.sort(b, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 0.1
        assert (a.argmax(1) == b.argmax(1))[clear].all()


def test_init_shapes_match_reference_layer_for_layer():
    cfg = _cfg()
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = JM.init_params(_jax_cfg(), jax.random.PRNGKey(0))
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[name].shape) == jp[name].shape
    assert len(tp["layers"]) == cfg.n_layers
    for path in (("ln1",), ("ln2",), ("attn", "wq"), ("attn", "wk"),
                 ("attn", "wv"), ("attn", "wo"), ("mlp", "w_gate"),
                 ("mlp", "w_up"), ("mlp", "w_down")):
        j, t = jp["layers"], tp["layers"][1]
        for key in path:
            j, t = j[key], t[key]
        assert (cfg.n_layers,) + tuple(t.shape) == j.shape, path
        assert t.dtype == torch.float32


def test_params_from_state_rejects_a_wrong_tree():
    tree = _numpy_tree(JM.init_params(_jax_cfg(), jax.random.PRNGKey(0)))
    bad = dict(tree, lm_head=tree["lm_head"][:, :7])
    with pytest.raises(ValueError, match="lm_head"):
        carry.params_from_state(_cfg(), bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        carry.params_from_state(_cfg(), {"embed": tree["embed"]}, "cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """No device means cuda: without a card every entry point raises, and
    only ``device="cpu"`` gives the CPU."""
    cfg = _cfg()
    assert TM.init_cache(cfg, 1, 4, device="cpu")["k"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGServer(cfg=cfg, params={}, store=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_demo_server(n_vectors=200, dim=8, n_roles=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        carry.params_from_state(cfg, {}, None)

"""The port's flash attention function against the reference's.

``flash_attention_ref`` (the plain version the Hopper kernel is held to, and
the CPU path of ``ops.flash_attention``) is compared with the reference's
Pallas kernel ``flash_attention_pallas`` in interpret mode, given the same
causal diagonal ``offset = q_offset``, and with the model's own attention,
``repro.models.layers._chunked_attention``.  Inputs come from a seeded numpy
generator; f32 cases hold to ``rtol=2e-4, atol=2e-5`` (the reference's own
kernel test tolerance), bf16 inputs to ``< 0.05`` against an f32 reference.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_ops_fa
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models.layers import _chunked_attention
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_ref, ops)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TILE = 32


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


def _pad(x, axis, m):
    pad = (-x.shape[axis]) % m
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _pallas(q, k, v, causal, q_offset, kv_len):
    """The reference's Pallas kernel in interpret mode on the model's
    layout: heads repeated and folded into the batch, rows padded to the
    tile, the diagonal given explicitly."""
    B, Sq, Hq, D = q.shape
    rep = Hq // k.shape[2]
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)

    def fold(x):
        return _pad(x.transpose(0, 2, 1, 3).reshape(B * Hq, x.shape[1], D),
                    1, TILE)
    out = flash_attention_pallas(
        jnp.asarray(fold(q)), jnp.asarray(fold(kr)), jnp.asarray(fold(vr)),
        jnp.int32(kv_len), causal=causal, bq=TILE, bk=TILE, offset=q_offset,
        sm_scale=float(D ** -0.5), interpret=True)
    out = np.asarray(out, np.float32)[:, :Sq].reshape(B, Hq, Sq, D)
    return out.transpose(0, 2, 1, 3)


def _chunked(q, k, v, causal, q_offset, kv_len):
    return np.asarray(_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, kv_len=kv_len, chunk=TILE))


def _port(q, k, v, causal, q_offset, kv_len, dtype=torch.float32):
    def t(x):
        return torch.from_numpy(x).to(dtype)
    return flash_attention_ref(t(q), t(k), t(v), causal=causal,
                               q_offset=q_offset, kv_len=kv_len).numpy()


# (B, Hq, Hkv, Sq, Sk, D, causal, q_offset, kv_len)
CASES = {
    # tests/test_kernels_flash.py's six cases, at the wrapper's diagonal
    # Sk - Sq and kv_len (Sk where it passes none)
    "aligned_gqa": (2, 4, 2, 128, 128, 32, True, 0, 128),
    "padding": (1, 2, 2, 100, 100, 64, True, 0, 100),
    "decode_kv_len": (1, 4, 1, 1, 256, 32, False, 255, 200),
    "offset": (2, 2, 2, 64, 192, 16, True, 128, 192),
    "full_tile": (1, 8, 8, 256, 256, 128, True, 0, 256),
    "unaligned": (1, 3, 1, 37, 75, 20, True, 38, 75),
    # the serve path: a prompt prefilled into a longer cache
    "prefill_into_cache": (1, 3, 1, 33, 41, 16, True, 0, 33),
    "chunk_at_offset": (2, 6, 2, 20, 80, 16, True, 30, 50),
    "decode_step": (2, 4, 2, 1, 64, 16, True, 40, 41),
    "gqa_15_5_hd64": (2, 15, 5, 37, 50, 64, True, 0, 37),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_version_matches_pallas_kernel_and_model_attention(case):
    B, Hq, Hkv, Sq, Sk, D, causal, off, kv_len = CASES[case]
    q, k, v = _inputs(B, Hq, Hkv, Sq, Sk, D)
    out = _port(q, k, v, causal, off, kv_len)
    assert out.shape == (B, Sq, Hq, D) and out.dtype == np.float32
    np.testing.assert_allclose(out, _pallas(q, k, v, causal, off, kv_len),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, _chunked(q, k, v, causal, off, kv_len),
                               rtol=2e-4, atol=2e-5)


def test_reference_wrapper_diagonal_is_not_the_serve_path():
    """The reference's ops wrapper fixes the diagonal at Sk - Sq, so a
    prompt prefilled into a longer cache would see the cache's future
    positions; the port's explicit q_offset matches the model instead."""
    q, k, v = _inputs(1, 3, 1, 33, 41, 16)
    model = _chunked(q, k, v, True, 0, 33)
    wrapper = np.asarray(jax_ops_fa(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), causal=True, kv_len=33)
    ).transpose(0, 2, 1, 3)
    assert np.abs(wrapper - model).max() > 0.1
    np.testing.assert_allclose(_port(q, k, v, True, 0, 33), model,
                               rtol=2e-4, atol=2e-5)


def test_bf16_inputs_close_to_fp32_reference():
    """As tests/test_kernels_flash.py: bf16 inputs, f32 math, within 0.05
    of the f32 reference (bf16 keeps 8 bits of mantissa)."""
    q, k, v = _inputs(1, 2, 2, 128, 128, 32, seed=1)
    out = _port(q, k, v, True, 0, 128, dtype=torch.bfloat16)
    assert out.dtype == np.float32
    assert np.max(np.abs(out - _chunked(q, k, v, True, 0, 128))) < 0.05


def test_fully_masked_rows_give_zero():
    q, k, v = _inputs(1, 2, 1, 4, 8, 16)
    out = _port(q, k, v, True, 0, 0)                # kv_len 0: nothing valid
    assert np.all(out == 0.0)


def test_constant_values_come_back():
    """Attention over constant V gives that constant (softmax sums to 1)."""
    q, k, _ = _inputs(1, 4, 2, 50, 50, 16, seed=2)
    v = np.full((1, 50, 2, 16), 3.25, np.float32)
    np.testing.assert_allclose(_port(q, k, v, True, 0, 50), 3.25, rtol=1e-5)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 70)])
def test_attention_ref_matches_reference(causal, kv_len):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, s, 16)).astype(np.float32)
               for s in (40, 90, 90))
    want = np.asarray(jax_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   kv_len=kv_len))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal,
                        kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_cpu_wrapper_takes_the_plain_version_and_does_not_count():
    q, k, v = _inputs(1, 4, 2, 9, 20, 16)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    before = ops.launches
    out = ops.flash_attention(*t, causal=True, q_offset=3, kv_len=12)
    assert ops.launches == before
    np.testing.assert_array_equal(out.numpy(), _port(q, k, v, True, 3, 12))


def test_wrapper_rejects_what_it_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 3, 2, 8, 16))
    with pytest.raises(ValueError, match="heads"):
        ops.flash_attention(q, k, v, causal=True, q_offset=0, kv_len=2)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, causal=True, q_offset=0, kv_len=9)
    meta = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(meta, meta[:, :, :2], meta[:, :, :2],
                            causal=True, q_offset=0, kv_len=2)


BANNED = ("scaled_dot_product", "cudnn", "flash_attn", "efficient_attention")


def _banned(node):
    """A library attention or torch.compile named by this AST node."""
    if isinstance(node, ast.Attribute):
        if node.attr == "compile" and getattr(node.value, "id", "") == "torch":
            return "torch.compile"
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.alias):
        name = node.name
    elif isinstance(node, ast.ImportFrom):
        name = node.module or ""
    else:
        return None
    return name if any(b in name for b in BANNED) else None


def test_port_wraps_no_library_attention():
    """The port's attention is its own kernel: no PyTorch fused attention,
    no cuDNN, no torch.compile anywhere under src/repro_torch/."""
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        found = [(getattr(n, "lineno", None), _banned(n))
                 for n in ast.walk(tree) if _banned(n)]
        assert not found, (path, found)


def test_library_attention_scan_sees_what_it_bans():
    src = ("import torch\nfrom torch.backends import cudnn\n"
           "f = torch.compile(g)\n"
           "y = torch.nn.functional.scaled_dot_product_attention(q, k, v)\n")
    found = {_banned(n) for n in ast.walk(ast.parse(src))} - {None}
    assert found == {"cudnn", "torch.compile",
                     "scaled_dot_product_attention"}

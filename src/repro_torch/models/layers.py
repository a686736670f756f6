"""Model layers of the dense family: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

Functional style, as in the reference's ``models/layers.py``: ``init_*``
returns a parameter dict (the reference's names), ``*_apply`` computes.
Projections, norms, rope and the MLP are plain PyTorch ops; attention is
the flash attention kernel (``kernels/flash_attention``), which computes the
function of the reference's ``_chunked_attention``.  The reference's
sharding ``rules`` argument is dropped: one card, no mesh.

Numerics: parameters in ``cfg.dtype`` (bf16 by default); norms, rope,
softmax and the silu gate in f32, cast back to the activation dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as flash_ops
from .config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _init(generator: torch.Generator, shape: Tuple[int, ...], scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in f32 on the generator's device, cast."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


# =============================================================== norms / rope
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer.  Half-split rotation
    (the first and second halves of hd are the pair), not interleaved."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ============================================================= attention (GQA)
def init_attention(cfg: ModelConfig, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
    """One layer's attention parameters on the generator's device."""
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(
            "qkv_bias / qk_norm attention is not ported yet (qwen2 / qwen3)")
    dt = _dtype(cfg)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    return {"wq": _init(generator, (d, h * hd), s, dt),
            "wk": _init(generator, (d, hkv * hd), s, dt),
            "wv": _init(generator, (d, hkv * hd), s, dt),
            "wo": _init(generator, (h * hd, d), (h * hd) ** -0.5, dt)}


def attention_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, positions: torch.Tensor,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_pos: Optional[int] = None,
                    ) -> Tuple[torch.Tensor,
                               Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """x: (B, S, D).  cache: (k, v) each (B, Smax, Hkv, hd).

    With a cache, the step's k and v are written into it at ``cache_pos``
    in the cache's dtype — in place, where the reference returns an updated
    copy — and attention runs over the whole cache with ``q_offset =
    cache_pos`` and ``kv_len = cache_pos + S``.  Returns (out (B, S, D) in
    x's dtype, the cache or None)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv = cache
        ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        out = flash_ops.flash_attention(q, ck, cv, causal=cfg.causal,
                                        q_offset=cache_pos,
                                        kv_len=cache_pos + s)
    else:
        out = flash_ops.flash_attention(q, k, v, causal=cfg.causal,
                                        q_offset=0, kv_len=s)
    out = out.reshape(b, s, h * hd).to(x.dtype) @ p["wo"]
    return out, cache


# ================================================================ SwiGLU MLP
def init_mlp(cfg: ModelConfig, generator: torch.Generator
             ) -> Dict[str, torch.Tensor]:
    """One layer's MLP parameters on the generator's device."""
    dt = _dtype(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": _init(generator, (d, f), d ** -0.5, dt),
            "w_up": _init(generator, (d, f), d ** -0.5, dt),
            "w_down": _init(generator, (f, d), f ** -0.5, dt)}


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    hidden = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return hidden @ p["w_down"]

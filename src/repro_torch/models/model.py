"""The generator LM of RAG serving, dense family: pre-norm GQA attention +
SwiGLU MLP blocks, as the reference's ``models/model.py`` builds them.

Parameters are a dict with the reference's names: ``embed`` (Vp, D),
``final_norm`` (D,), ``lm_head`` (D, Vp) and ``layers``, a list with one
dict per layer (``ln1``, ``attn`` {wq, wk, wv, wo}, ``ln2``, ``mlp``
{w_gate, w_up, w_down}) where the reference stacks each leaf over layers.

The cache is ``{"k": (L, B, Smax, Hkv, hd), "v": ...}``, the reference's
layout; ``cache["k"][i]`` is layer i's contiguous (B, Smax, Hkv, hd) slab,
which the attention kernel reads in place.  ``forward`` writes each step's
k and v into it in place and returns the same dict.

MoE, SSM, hybrid and the modality frontends, ``loss_fn`` and training wait
for later slices (ROADMAP).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.frontend is not None:
        raise NotImplementedError(
            f"the port serves the dense family only, not {cfg.family!r}"
            + (f" with a {cfg.frontend} frontend" if cfg.frontend else ""))


# ================================================================ init
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict:
    """Random parameters drawn from ``generator`` (a generator on the device;
    ``None`` → one seeded with 0), on ``device`` (``None`` → ``cuda``, which
    raises without a card)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"parameters go to {dev}")
    dt = L._dtype(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab

    def ones():
        return torch.ones((d,), dtype=dt, device=dev)

    params: Dict = {
        "embed": L._init(generator, (vp, d), d ** -0.5, dt),
        "final_norm": ones(),
        "lm_head": L._init(generator, (d, vp), d ** -0.5, dt),
    }
    params["layers"] = [{"ln1": ones(), "attn": L.init_attention(cfg, generator),
                         "ln2": ones(), "mlp": L.init_mlp(cfg, generator)}
                        for _ in range(cfg.n_layers)]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache ``{"k", "v"}`` of (L, B, max_seq, Hkv, hd) in
    ``dtype`` (``None`` → the model's dtype) on ``device`` (``None`` →
    ``cuda``, which raises without a card)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = L._dtype(cfg) if dtype is None else dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


# ================================================================ forward
def _attn_block(p, h, cfg, positions, cache, cache_pos):
    a_out, _ = L.attention_apply(p["attn"], L.rms_norm(h, p["ln1"],
                                                       cfg.norm_eps),
                                 cfg, positions, cache=cache,
                                 cache_pos=cache_pos)
    h = h + a_out
    return h + L.mlp_apply(p["mlp"], L.rms_norm(h, p["ln2"], cfg.norm_eps))


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_pos: Optional[int] = None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """tokens (B, S) integer.  Returns (hidden (B, S, D) after the final
    norm, the cache — updated in place — or None)."""
    _check_dense(cfg)
    h = params["embed"][tokens.long()]
    b, s = tokens.shape
    pos0 = 0 if cache_pos is None else int(cache_pos)
    positions = (pos0 + torch.arange(s, device=h.device)).expand(b, s)
    for i, p_layer in enumerate(params["layers"]):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        h = _attn_block(p_layer, h, cfg, positions, kv, pos0)
    return L.rms_norm(h, params["final_norm"], cfg.norm_eps), cache


# =============================================================== serve steps
def prefill_fn(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: run the prompt from position 0, fill the cache (a new one
    the prompt's length if none is given), return last-token logits
    (B, Vp) in the model's dtype and the cache."""
    if cache is None:
        b, s = tokens.shape
        cache = init_cache(cfg, b, s, device=tokens.device)
    h, cache = forward(params, cfg, tokens, cache=cache, cache_pos=0)
    return h[:, -1] @ params["lm_head"], cache


def decode_fn(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              cache: Dict[str, torch.Tensor], cache_pos: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode step: tokens (B, 1) at position ``cache_pos``."""
    h, cache = forward(params, cfg, tokens, cache=cache, cache_pos=cache_pos)
    return h[:, -1] @ params["lm_head"], cache

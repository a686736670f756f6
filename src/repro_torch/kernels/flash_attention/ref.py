"""Plain PyTorch versions of attention: the CPU path and the oracle the
Hopper kernel is held to.

  * :func:`attention_ref` — the reference package's ``attention_ref``:
    (B, H, S, D) with as many kv heads as query heads, causal rows aligned
    to the last position (diagonal ``Sk - Sq``), optional ``kv_len``.
  * :func:`flash_attention_ref` — the function the kernel computes, in the
    model's layout: q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), query head
    h reads kv head h // (Hq // Hkv); column n is valid for query position
    i iff ``n < kv_len`` and, when causal, ``n <= i + q_offset``; f32 math,
    f32 output; a row with no valid column gives 0.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, kv_len: Optional[int] = None
                  ) -> torch.Tensor:
    """Softmax attention. q, k, v: (B, H, S, D) (kv heads == q heads)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d ** 0.5
    sq, sk = q.shape[2], k.shape[2]
    col = torch.arange(sk, device=q.device)[None, :]
    if causal:
        row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = s.masked_fill(col > row, float("-inf"))
    if kv_len is not None:
        s = s.masked_fill(col >= kv_len, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def valid_mask(sq: int, sk: int, *, causal: bool, q_offset: int,
               kv_len: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which kv columns each query position may see."""
    col = torch.arange(sk, device=device)[None, :]
    valid = col < kv_len
    if causal:
        row = torch.arange(sq, device=device)[:, None] + q_offset
        valid = valid & (col <= row)
    return valid


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_offset: int, kv_len: int
                        ) -> torch.Tensor:
    """The kernel's function on any device (see module docstring)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, sq, hkv, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * hd ** -0.5
    valid = valid_mask(sq, sk, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, device=q.device)
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                       # exp(-inf) = 0 where masked
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)

"""Public wrapper for forward flash attention.

One dispatch, on the device of ``q``: CPU tensors go to the plain PyTorch
version (``ref.flash_attention_ref``), CUDA tensors to the Hopper kernel
(``kernel.flash_attention_cuda``), which raises on anything it does not
take.  There is no fallback from the kernel to the plain version.

``launches`` counts the calls that launched the kernel, so a run can show
that its main path went through it.

The causal diagonal is explicit: ``q_offset`` is the position of q's first
row in the kv sequence.  The reference package's ``ops.flash_attention``
derives it as ``Sk - Sq``, which is wrong for a prompt prefilled into a
cache longer than the prompt (``Sk = prompt + decode tokens``); the model
passes ``q_offset = cache_pos`` and ``kv_len = cache_pos + Sq``.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_ref

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int, kv_len: int
                    ) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, hd) over k, v (B, Sk, Hkv, hd), grouped
    query heads by index (Hq a multiple of Hkv).  Column n is valid for query
    position i iff ``n < kv_len`` and, when causal, ``n <= i + q_offset``.
    Returns (B, Sq, Hq, hd) float32; a row with no valid column gives 0."""
    global launches
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads over {k.shape[2]} kv "
                         f"heads")
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len={kv_len} outside 0..{k.shape[1]}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    out = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len)
    launches += 1
    return out

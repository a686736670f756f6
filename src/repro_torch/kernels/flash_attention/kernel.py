"""Load and launch the Hopper flash attention kernel (csrc/flash_attention.cu).

``LIBRARY`` builds the CUDA source with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` the first time a CUDA tensor reaches the kernel, and
loads it with ``ctypes`` (see ``kernels/_build.py``).  Nothing here runs at
import time, so the CPU tests import the module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

MAX_HEAD_DIM = 128       # csrc/flash_attention.cu's MAX_HD
DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention",
                      Path(__file__).resolve().parent / "csrc",
                      ("flash_attention.cu",), _declare)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int, kv_len: int
                         ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (no fallback: anything it does not
    take raises).  q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), all float32
    or all bfloat16, each with a contiguous last dim (other strides are
    read as they are, so a cache is attended in place); Hq a multiple of
    Hkv, hd <= MAX_HEAD_DIM, 0 <= kv_len <= Sk.  Returns (B, Sq, Hq, hd)
    float32 in stream order on the current stream (no synchronisation)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the flash attention kernel takes CUDA tensors, "
                         f"got {device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {DTYPES}, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} kv heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes 1..{MAX_HEAD_DIM}")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside 0..{sk}")
    if q_offset < 0 or q_offset + sq >= 2 ** 31:
        raise ValueError(f"q_offset={q_offset}: positions must fit int32")
    if min(b, sq, sk) < 1 or b > 65535 or hkv > 65535:
        raise ValueError(f"unsupported sizes B={b} Sq={sq} Sk={sk} "
                         f"Hkv={hkv}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a contiguous last dim")
    lib = LIBRARY.load()
    out = torch.empty((b, sq, hq, hd), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, sq, sk, hq, hkv, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(q_offset), int(kv_len), float(hd) ** -0.5,
            stream)
    if err != 0:
        raise RuntimeError("flash attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    return out

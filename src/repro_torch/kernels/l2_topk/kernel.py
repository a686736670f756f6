"""Load and launch the Hopper ``l2_topk`` kernel (csrc/l2_topk.cu).

``LIBRARY`` builds the CUDA source with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` the first time a CUDA tensor reaches the kernel, and
loads it with ``ctypes`` (see ``kernels/_build.py``).  Nothing here runs at
import time, so the CPU tests import the module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import CudaLibrary

# Limits of csrc/l2_topk.cu (its BQ / TN / MAX_SPLITS / MAX_W / MAX_P / KMAX).
QUERY_TILE = 16
ROW_TILE = 128
MAX_SPLITS = 256
MAX_WORDS = 8
MAX_PRED_WORDS = 4
MAX_K = 128
CTAS_PER_SM = 4          # split target: this many CTAs per SM


def _declare(lib: ctypes.CDLL) -> None:
    lib.l2_topk_launch.argtypes = ([ctypes.c_void_p] * 9
                                   + [ctypes.c_int] * 8
                                   + [ctypes.c_void_p] * 5)
    lib.l2_topk_launch.restype = ctypes.c_int
    lib.l2_topk_error_string.argtypes = [ctypes.c_int]
    lib.l2_topk_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("l2_topk", Path(__file__).resolve().parent / "csrc",
                      ("l2_topk.cu",), _declare)


def split_rows(b: int, n: int, n_sms: int) -> Tuple[int, int]:
    """``(S, chunk)``: the N rows cut into S contiguous ranges of ``chunk``
    rows (a multiple of the row tile), enough CTAs to fill the card even at
    B = 1, at most MAX_SPLITS ranges, and no empty range."""
    q_tiles = -(-b // QUERY_TILE)
    row_tiles = -(-n // ROW_TILE)
    s = max(1, min(MAX_SPLITS, -(-CTAS_PER_SM * n_sms // q_tiles), row_tiles))
    chunk = -(-row_tiles // s) * ROW_TILE
    return -(-n // chunk), chunk


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; the kernel needs every "
                         f"operand on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def l2_topk_cuda(queries: torch.Tensor, db: torch.Tensor,
                 db_norms: torch.Tensor, auth_words: torch.Tensor,
                 role_rows: torch.Tensor, bounds: torch.Tensor, k: int,
                 attr_words: Optional[torch.Tensor] = None,
                 require: Optional[torch.Tensor] = None,
                 forbid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors (no fallback: anything it does not
    take raises).  Operands: queries (B, d) and db (N, d) float32, db_norms
    (N,) float32, auth_words (W, N) and role_rows (B, W) int32 word bits,
    bounds (B,) float32, optional attr_words (P, N) with require / forbid
    (B, P) int32.  B, N >= 1.  Returns (dists (B, k) float32, local row ids
    (B, k) int32), +inf / -1 in empty slots, in stream order on the current
    stream (no synchronisation)."""
    device = queries.device
    if device.type != "cuda":
        raise ValueError(f"the l2_topk kernel takes CUDA tensors, got "
                         f"{device}")
    if queries.ndim != 2 or db.ndim != 2 or auth_words.ndim != 2:
        raise ValueError("queries, db and auth_words must be 2-d")
    b, d = queries.shape
    n = db.shape[0]
    w = auth_words.shape[0]
    p = 0 if attr_words is None else attr_words.shape[0]
    _check(queries, "queries", torch.float32, (b, d), device)
    _check(db, "db", torch.float32, (n, d), device)
    _check(db_norms, "db_norms", torch.float32, (n,), device)
    _check(auth_words, "auth_words", torch.int32, (w, n), device)
    _check(role_rows, "role_rows", torch.int32, (b, w), device)
    _check(bounds, "bounds", torch.float32, (b,), device)
    if (attr_words is None) != (require is None) or \
            (attr_words is None) != (forbid is None):
        raise ValueError("attr_words, require and forbid come together")
    if p:
        _check(attr_words, "attr_words", torch.int32, (p, n), device)
        _check(require, "require", torch.int32, (b, p), device)
        _check(forbid, "forbid", torch.int32, (b, p), device)
    if not 1 <= w <= MAX_WORDS:
        raise ValueError(f"{w} auth words: the kernel takes 1..{MAX_WORDS}")
    if not 0 <= p <= MAX_PRED_WORDS:
        raise ValueError(f"{p} predicate words: the kernel takes "
                         f"0..{MAX_PRED_WORDS}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernel takes 1..{MAX_K}")
    if b < 1 or n < 1 or d < 1 or n > 2 ** 31 - 2 ** 24:
        raise ValueError(f"unsupported sizes B={b} N={n} d={d}")
    lib = LIBRARY.load()
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    s, chunk = split_rows(b, n, n_sms)
    part_d = torch.empty((b, s, k), dtype=torch.float32, device=device)
    part_i = torch.empty((b, s, k), dtype=torch.int32, device=device)
    out_d = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.l2_topk_launch(
            ptr(queries), ptr(db), ptr(db_norms), ptr(auth_words),
            ptr(role_rows), ptr(bounds), ptr(attr_words), ptr(require),
            ptr(forbid), b, n, d, k, w, p, s, chunk, ptr(part_d),
            ptr(part_i), ptr(out_d), ptr(out_i), stream)
    if err != 0:
        raise RuntimeError("l2_topk launch failed: "
                           + lib.l2_topk_error_string(err).decode())
    return out_d, out_i

"""Public wrapper for the authorized L2 top-k scan.

One dispatch, on the device of the query tensor: CPU tensors go to the
plain PyTorch version (``ref.l2_topk_words_ref``), CUDA tensors to the Hopper
kernel (``kernel.l2_topk_cuda``), which raises on anything it does not
take.  There is no fallback from the kernel to the plain version.

``launches`` counts the calls that launched the kernel, so a run can show
that its main path went through it.

Two entry points:
  * :func:`l2_topk` takes the reference's operand forms — ``(N,)`` / ``(N,
    W)`` auth words, scalar / ``(B,)`` / ``(W,)`` / ``(B, W)`` role masks,
    scalar or ``(B,)`` bounds — normalizes them and calls
  * :func:`l2_topk_words` on the kernel's own layout: ``(W, N)`` word-major
    auth words, ``(B, W)`` role rows, ``(B,)`` bounds, optional ``(P, N)``
    attribute words with ``(B, P)`` require / forbid rows, and optionally
    the resident ``|v|^2``.  ScoreScan engines call it with tensors that
    live on the device, so only the query-side operands cross per call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import kernel
from .ref import (INF, l2_topk_words_ref, normalize_masks,
                  normalize_predicates, per_query)

launches = 0


@dataclasses.dataclass(frozen=True)
class L2TopKConfig:
    """The reference's launch-config slot.  It has no fields: the Hopper
    kernel's tile sizes and its k limit (``kernel.MAX_K``) are constants of
    ``csrc/l2_topk.cu``, and the CPU path holds to the same limit."""


def l2_topk(queries: torch.Tensor, db: torch.Tensor, auth_bits, role_mask,
            k: int, bound=None, config: L2TopKConfig = L2TopKConfig(),
            attr_bits=None, require=None, forbid=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Authorized top-k nearest neighbours of each query under L2.

    Args:
      queries: (B, d) float32 tensor; its device picks the path.
      db: (N, d) float32 tensor on the same device.
      auth_bits: (N,) single-word role masks, or (N, W) packed words
        (uint32 numpy arrays, or uint32 / int32 tensors).
      role_mask: scalar or (B,) for single-word masks; (W,) shared or
        (B, W) per query for multi-word.
      k: neighbours to return (1 <= k <= kernel.MAX_K).
      bound: optional k-th distance bound, scalar or (B,); candidates at or
        beyond it are pruned.
      config: the reference's config slot (no fields, see L2TopKConfig).
      attr_bits: optional (N, P) packed attribute words.
      require: optional (P,) shared or (B, P) required-bits rows.
      forbid: optional (P,) shared or (B, P) forbidden-bits rows.

    Returns:
      (dists (B, k) float32, ids (B, k) int32); empty slots are +inf / -1.
    """
    device = queries.device
    b = queries.shape[0]
    auth, mask, w = normalize_masks(auth_bits, role_mask, device)
    pred = normalize_predicates(attr_bits, require, forbid, device)
    pkw = {}
    if pred is not None:
        attr, req, forb, p = pred
        pkw = dict(attr_words=attr.t().contiguous(),
                   require=req.expand(b, p).contiguous(),
                   forbid=forb.expand(b, p).contiguous())
    return l2_topk_words(
        queries.to(torch.float32).contiguous(),
        db.to(torch.float32).contiguous(), auth.t().contiguous(),
        mask.expand(b, w).contiguous(),
        per_query(INF if bound is None else bound, b, device).contiguous(),
        k, **pkw)


def l2_topk_words(queries: torch.Tensor, db: torch.Tensor,
                  auth_words: torch.Tensor, role_rows: torch.Tensor,
                  bounds: torch.Tensor, k: int, *,
                  db_norms: Optional[torch.Tensor] = None,
                  attr_words: Optional[torch.Tensor] = None,
                  require: Optional[torch.Tensor] = None,
                  forbid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`l2_topk` on the kernel layout (see module docstring)."""
    global launches
    if not 1 <= k <= kernel.MAX_K:
        raise ValueError(f"k={k} outside 1..{kernel.MAX_K}")
    device = queries.device
    b, n = queries.shape[0], db.shape[0]
    if b == 0 or n == 0:
        return (torch.full((b, k), INF, device=device),
                torch.full((b, k), -1, dtype=torch.int32, device=device))
    if device.type == "cpu":
        return l2_topk_words_ref(queries, db, auth_words, role_rows, bounds,
                                 k, db_norms=db_norms, attr_words=attr_words,
                                 require=require, forbid=forbid)
    if db_norms is None:
        db_norms = torch.sum(db * db, dim=1)
    out = kernel.l2_topk_cuda(queries, db, db_norms, auth_words, role_rows,
                              bounds, k, attr_words=attr_words,
                              require=require, forbid=forbid)
    launches += 1
    return out

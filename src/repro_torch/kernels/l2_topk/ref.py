"""Plain PyTorch version of the authorized L2 top-k scan.

It is the CPU path of :func:`~repro_torch.kernels.l2_topk.ops.l2_topk` and
the yardstick the Hopper kernel is held to on the card.  Semantics (shared
with the kernel):

  * distance = ||q||^2 + ||v||^2 - 2 q.v in float32 over the database,
  * a vector is a candidate iff its auth words intersect the query's role
    words in ANY packed word AND its distance is strictly below ``bound``
    (the coordinated-search k-th distance; +inf disables the bound),
  * when a predicate plane is given, a vector must also pass, in every
    word, ``(attr & require) == require`` and ``(attr & forbid) == 0``,
  * non-candidates get distance +inf and id -1,
  * ties go to the smaller database id: a stable sort over id-ordered
    columns (``torch.topk`` leaves the tie order unspecified).

Auth masks come in two layouts (DESIGN.md §Role Masks):
  * single word: ``auth_bits`` ``(N,)`` and ``role_mask`` a scalar or
    ``(B,)`` vector,
  * multi-word (W = ceil(n_roles/32) packed words): ``auth_bits`` ``(N, W)``
    and ``role_mask`` ``(W,)`` (shared) or ``(B, W)`` (one row per query).

Mask and attribute words are packed uint32 in the reference.  Here they are
held as ``int32`` tensors with the same bits: ``&``, ``==`` and ``!= 0`` give
the same answers, and int32 has bitwise kernels on every device.
"""
from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def as_words(x, device) -> torch.Tensor:
    """Packed uint32 words (numpy array, Python or numpy scalar, or a uint32
    / int32 tensor) as an int32 tensor with the same bits on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        if x.dtype != torch.int32:
            raise TypeError(f"mask words must be uint32 or int32, got {x.dtype}")
        dev = torch.device(device)
        if x.device.type != dev.type or (dev.index is not None
                                         and x.device.index != dev.index):
            raise ValueError(f"mask words on {x.device}, expected {dev}")
        return x
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32)
    return torch.from_numpy(arr).to(device)


def per_query(x, b: int, device) -> torch.Tensor:
    """A scalar or ``(B,)`` float operand as a ``(B,)`` float32 tensor."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)
    if t.numel() not in (1, b):
        raise ValueError(f"per-query operand has {t.numel()} values for "
                         f"{b} queries")
    return t.expand(b)


def normalize_masks(auth_bits, role_mask, device):
    """Common (N, W) auth / (·, W) role-mask normalization for ref + ops.

    Returns ``(auth (N, W), mask (B'|1, W), W)`` int32 tensors.  Single-word
    operands keep their legacy forms: ``(N,)`` auth with a scalar or ``(B,)``
    mask.  For ``W > 1`` the mask must carry all W words — ``(W,)`` shared or
    ``(B, W)`` per query; a bare scalar/(B,) would silently drop roles >= 32,
    so it is rejected.
    """
    auth = as_words(auth_bits, device)
    if auth.ndim == 1:
        auth = auth[:, None]                                     # (N, 1)
    w = auth.shape[1]
    mask = as_words(role_mask, device)
    if w == 1:
        mask = mask.reshape(-1)[:, None]                         # (B'|1, 1)
    elif mask.ndim == 1:
        if mask.shape[0] != w:
            raise ValueError(
                f"role_mask must carry all {w} mask words: got shape "
                f"{tuple(mask.shape)} (per-query masks are (B, {w}))")
        mask = mask[None, :]                                     # (1, W)
    elif mask.ndim == 2 and mask.shape[1] == w:
        pass                                                     # (B, W)
    else:
        raise ValueError(
            f"role_mask shape {tuple(mask.shape)} incompatible with {w}-word "
            f"auth masks")
    return auth, mask, w


def normalize_predicates(attr_bits, require, forbid, device):
    """Common (N, P) attr / (·, P) require/forbid normalization for ref + ops.

    Returns ``(attr (N, P), require (B'|1, P), forbid (B'|1, P), P)`` int32
    tensors, or ``None`` when ``attr_bits`` is None (the unfiltered path).
    ``require``/``forbid`` may be ``None`` (all-zero: no constraint on that
    side), ``(P,)`` shared, or ``(B, P)`` per query — like role masks, a row
    that drops words would silently pass bits past word 0, so short rows are
    rejected.
    """
    if attr_bits is None:
        if require is not None or forbid is not None:
            raise ValueError(
                "require/forbid word rows need (N, P) attr_bits to filter on")
        return None
    attr = as_words(attr_bits, device)
    if attr.ndim == 1:
        attr = attr[:, None]                                     # (N, 1)
    p = attr.shape[1]

    def _rows(x, name):
        if x is None:
            return torch.zeros((1, p), dtype=torch.int32, device=device)
        x = as_words(x, device)
        if x.ndim == 0:
            x = x.reshape(1)
        if x.ndim == 1:
            if x.shape[0] != p:
                raise ValueError(
                    f"{name} must carry all {p} predicate words: got shape "
                    f"{tuple(x.shape)} (per-query rows are (B, {p}))")
            return x[None, :]                                    # (1, P)
        if x.ndim == 2 and x.shape[1] == p:
            return x                                             # (B, P)
        raise ValueError(
            f"{name} shape {tuple(x.shape)} incompatible with {p}-word attr "
            f"plane")

    return attr, _rows(require, "require"), _rows(forbid, "forbid"), p


def l2_topk_ref(queries: torch.Tensor, db: torch.Tensor, auth_bits,
                role_mask, bound, k: int, attr_bits=None, require=None,
                forbid=None, db_norms: torch.Tensor = None):
    """Plain authorized top-k.

    Args:
      queries: (B, d) float32.
      db: (N, d) float32, on the same device.
      auth_bits: (N,) single-word masks, or (N, W) packed words.
      role_mask: querying-role mask — scalar or (B,) single-word, or
        (W,) / (B, W) word rows (see module docstring).
      bound: k-th distance bound (inf = no bound) — scalar or (B,).
      k: number of neighbours.
      attr_bits: optional (N, P) packed attribute words.
      require: optional (P,) / (B, P) required-bits word rows.
      forbid: optional (P,) / (B, P) forbidden-bits word rows.
      db_norms: optional (N,) precomputed ``|v|^2``; computed when None.

    Returns:
      dists (B, k) float32 (+inf for empty slots), ids (B, k) int32 (-1).
    """
    device = queries.device
    queries = queries.to(torch.float32)
    db = db.to(torch.float32)
    b, n = queries.shape[0], db.shape[0]
    qn = torch.sum(queries * queries, dim=1, keepdim=True)          # (B, 1)
    dn = (torch.sum(db * db, dim=1) if db_norms is None
          else db_norms.to(torch.float32))[None, :]                 # (1, N)
    dist = qn + dn - 2.0 * queries @ db.T                           # (B, N)
    auth, mask, w = normalize_masks(auth_bits, role_mask, device)
    # any-word OR, one (B'|1, N) word compare at a time; W == 1 is the
    # single-word (auth & mask) != 0 compare
    ok = (auth[None, :, 0] & mask[:, 0:1]) != 0
    for j in range(1, w):
        ok = ok | ((auth[None, :, j] & mask[:, j:j + 1]) != 0)
    dist = torch.where(ok, dist, INF)
    pred = normalize_predicates(attr_bits, require, forbid, device)
    if pred is not None:
        attr, req, forb, p = pred
        # all-word AND: every required bit set, no forbidden bit set
        for j in range(p):
            a = attr[None, :, j]
            r = req[:, j:j + 1]
            pok = ((a & r) == r) & ((a & forb[:, j:j + 1]) == 0)
            dist = torch.where(pok, dist, INF)
    dist = torch.where(dist < per_query(bound, b, device)[:, None], dist, INF)
    # ties toward the smaller id: stable sort over id-ordered columns
    top_d, order = torch.sort(dist, dim=1, stable=True)
    top_d, order = top_d[:, :k], order[:, :k]
    top_i = torch.where(torch.isinf(top_d), -1, order.to(torch.int32))
    if top_d.shape[1] < k:                       # fewer rows than k
        pad = k - top_d.shape[1]
        top_d = torch.cat([top_d, torch.full((b, pad), INF, device=device)], 1)
        top_i = torch.cat([top_i, torch.full((b, pad), -1, dtype=torch.int32,
                                             device=device)], 1)
    return top_d, top_i.to(torch.int32)


def l2_topk_words_ref(queries: torch.Tensor, db: torch.Tensor,
                      auth_words: torch.Tensor, role_rows: torch.Tensor,
                      bounds: torch.Tensor, k: int, *,
                      db_norms: torch.Tensor = None,
                      attr_words: torch.Tensor = None,
                      require: torch.Tensor = None,
                      forbid: torch.Tensor = None):
    """:func:`l2_topk_ref` on the kernel's operand layout: ``(W, N)`` auth
    words, ``(B, W)`` role rows, ``(B,)`` bounds, optional ``(P, N)``
    attribute words with ``(B, P)`` require / forbid rows."""
    pkw = {}
    if attr_words is not None:
        pkw = dict(attr_bits=attr_words.t(), require=require, forbid=forbid)
    return l2_topk_ref(queries, db, auth_words.t(), role_rows, bounds, k,
                       db_norms=db_norms, **pkw)

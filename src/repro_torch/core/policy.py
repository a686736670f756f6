"""Role-based access-control policies over vector datasets (paper §3.1).

Each vector carries a *role combination* ``tau`` (subset of roles) naming the
roles authorized to read it.  The set of vectors tagged with exactly ``tau`` is
the *exclusive block* ``N^ex(tau)``; the blocks partition the dataset.

The synthetic generator mirrors the paper's setup (§7.1): block sizes follow a
shifted Zipf distribution ``(i+s)^-alpha`` and the number of blocks touching a
role follows ``(j+s')^-alpha'`` (the *permission distribution*), so a few roles
are associated with substantially more data than the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

Role = int
RoleSet = FrozenSet[Role]

# Packed auth-mask word size.  The in-kernel authorization filter carries
# uint32 words; a role universe wider than one word uses W = ceil(n_roles/32)
# packed words per vector / per query row (DESIGN.md §Role Masks).
MASK_WORD_BITS = 32


def mask_words(n_roles: int) -> int:
    """Auth-mask width in uint32 words for a role universe of ``n_roles``."""
    return max(1, -(-int(n_roles) // MASK_WORD_BITS))


def roles_word_mask(roles: Sequence[Role], width: int) -> np.ndarray:
    """Exact ``(width,)`` uint32 word-array mask for a role set.

    Role ``r`` sets bit ``r % 32`` of word ``r // 32``.  A role that does not
    fit the given width is a hard error — masks never alias (the silent
    ``1 << (r % 32)`` wraparound this replaces made role 33 alias role 1).
    """
    out = np.zeros(int(width), dtype=np.uint32)
    for r in roles:
        r = int(r)
        if not 0 <= r < width * MASK_WORD_BITS:
            raise ValueError(
                f"role {r} does not fit a {width}-word auth mask "
                f"(max role {width * MASK_WORD_BITS - 1}); widen the mask "
                f"instead of aliasing")
        out[r // MASK_WORD_BITS] |= np.uint32(1) << np.uint32(
            r % MASK_WORD_BITS)
    return out


def roles_kernel_mask(roles: Sequence[Role], n_roles: int):
    """In-kernel filter operand for one role set: a ``np.uint32`` scalar when
    the role universe fits one word (the kernel's single-word fast path),
    else a ``(W,)`` uint32 word array."""
    w = mask_words(n_roles)
    words = roles_word_mask(roles, width=w)
    return np.uint32(words[0]) if w == 1 else words


@dataclasses.dataclass(frozen=True)
class AccessPolicy:
    """Immutable access-control assignment for a dataset of ``n`` vectors.

    Attributes:
      n_roles: number of distinct roles ``|R|``.
      block_roles: role combination ``tau`` of each exclusive block.
      block_members: vector ids of each exclusive block (disjoint, complete).
    """

    n_roles: int
    block_roles: Tuple[RoleSet, ...]
    block_members: Tuple[np.ndarray, ...]

    # ------------------------------------------------------------------ sizes
    @property
    def n_blocks(self) -> int:
        return len(self.block_roles)

    @property
    def n_vectors(self) -> int:
        return int(sum(len(m) for m in self.block_members))

    def block_size(self, b: int) -> int:
        return int(len(self.block_members[b]))

    @property
    def block_sizes(self) -> np.ndarray:
        return np.array([len(m) for m in self.block_members], dtype=np.int64)

    # ------------------------------------------------------------ role access
    def roles(self) -> range:
        return range(self.n_roles)

    def blocks_of_role(self, r: Role) -> List[int]:
        """Exclusive blocks authorized for ``r`` (``L_ex[r]``)."""
        return [b for b, tau in enumerate(self.block_roles) if r in tau]

    def d_of_role(self, r: Role) -> np.ndarray:
        """All vector ids accessible to ``r`` — ``D(r)``."""
        blocks = self.blocks_of_role(r)
        if not blocks:
            return np.empty(0, dtype=np.int64)
        return np.concatenate([self.block_members[b] for b in blocks])

    def d_of_roleset(self, taus: Sequence[Role]) -> np.ndarray:
        """Union semantics for multi-role queries: ``D(tau) = U_r D(r)``."""
        ids: List[np.ndarray] = []
        want = set(taus)
        for b, tau in enumerate(self.block_roles):
            if tau & want:
                ids.append(self.block_members[b])
        if not ids:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(ids)

    def authorized_mask(self, r: Role) -> np.ndarray:
        # sized to the max id, not the live count: dynamic stores (App. I)
        # tombstone deletions, so ids can exceed the live-vector count
        top = max((int(m.max()) + 1 for m in self.block_members if len(m)),
                  default=0)
        mask = np.zeros(max(self.n_vectors, top), dtype=bool)
        mask[self.d_of_role(r)] = True
        return mask

    def role_bitmask(self, max_roles: int = 64) -> np.ndarray:
        """Legacy per-vector single-word uint64 role bitmask.

        Only valid when the role universe fits ``max_roles`` bits; a wider
        universe is a hard error (the silent ``r % max_roles`` fold this
        replaces made role 33 alias role 1 in-kernel).  Wide universes use
        :meth:`role_words` instead.
        """
        if self.n_roles > max_roles:
            raise ValueError(
                f"n_roles={self.n_roles} does not fit a {max_roles}-bit "
                f"mask; use role_words() (multi-word auth masks)")
        out = np.zeros(self.n_vectors, dtype=np.uint64)
        for b, tau in enumerate(self.block_roles):
            bits = np.uint64(0)
            for r in tau:
                bits |= np.uint64(1) << np.uint64(r)
            out[self.block_members[b]] = bits
        return out

    def role_words(self) -> np.ndarray:
        """Exact per-vector packed auth words: ``(n_vectors, W)`` uint32 with
        ``W = ceil(n_roles / 32)`` — the multi-word mask the ScoreScan engine
        filters on in-kernel (DESIGN.md §Role Masks).  Works for any role
        universe width; no aliasing."""
        w = mask_words(self.n_roles)
        # sized to the max id like authorized_mask: dynamic stores (App. I)
        # tombstone deletions, so live ids can exceed the live-vector count
        top = max((int(m.max()) + 1 for m in self.block_members if len(m)),
                  default=0)
        out = np.zeros((max(self.n_vectors, top), w), dtype=np.uint32)
        for b, tau in enumerate(self.block_roles):
            out[self.block_members[b]] = roles_word_mask(tau, width=w)
        return out

    def oracle_storage(self) -> int:
        """Total vectors stored by the oracle index (one pure index per role)."""
        return int(sum(len(tau) * len(m)
                       for tau, m in zip(self.block_roles, self.block_members)))


def _shifted_zipf(n: int, s: float, alpha: float) -> np.ndarray:
    w = (np.arange(1, n + 1, dtype=np.float64) + s) ** (-alpha)
    return w / w.sum()


def generate_policy(
    n_vectors: int,
    n_roles: int = 16,
    n_permissions: int = 48,
    block_zipf: Tuple[float, float] = (1.0, 1.5),
    perm_zipf: Tuple[float, float] = (2.0, 1.5),
    max_roles_per_perm: int = 5,
    seed: int = 0,
) -> AccessPolicy:
    """Generate a synthetic RBAC policy following the paper's §7.1 recipe.

    ``n_permissions`` distinct role combinations are drawn; combination sizes
    are biased small (role-aligned blocks, paper §1 property (i)).  Vectors are
    assigned to combinations via a shifted-Zipf block-size distribution; how
    many combinations mention a role follows the permission distribution.
    """
    rng = np.random.default_rng(seed)
    # --- draw distinct role combinations -----------------------------------
    perm_weights = _shifted_zipf(n_roles, *perm_zipf)
    combos: List[RoleSet] = []
    seen = set()
    # Guarantee every role appears at least once (singleton combos first).
    for r in range(min(n_roles, n_permissions)):
        combos.append(frozenset([r]))
        seen.add(frozenset([r]))
    attempts = 0
    while len(combos) < n_permissions and attempts < 50 * n_permissions:
        attempts += 1
        size = int(rng.integers(1, min(max_roles_per_perm, n_roles) + 1))
        tau = frozenset(
            rng.choice(n_roles, size=size, replace=False, p=perm_weights))
        if tau not in seen:
            seen.add(tau)
            combos.append(tau)
    # --- assign vectors to blocks -------------------------------------------
    block_w = _shifted_zipf(len(combos), *block_zipf)
    order = rng.permutation(len(combos))  # decouple size rank from role rank
    assign = rng.choice(len(combos), size=n_vectors, p=block_w[order][np.argsort(order)])
    # Make sure no block is empty (move one vector into any empty block).
    counts = np.bincount(assign, minlength=len(combos))
    spare = np.flatnonzero(counts > 1)
    for b in np.flatnonzero(counts == 0):
        donor = spare[rng.integers(len(spare))]
        victim = np.flatnonzero(assign == donor)[0]
        assign[victim] = b
        counts = np.bincount(assign, minlength=len(combos))
        spare = np.flatnonzero(counts > 1)
    members = tuple(
        np.flatnonzero(assign == b).astype(np.int64) for b in range(len(combos)))
    return AccessPolicy(n_roles=n_roles, block_roles=tuple(combos),
                        block_members=members)

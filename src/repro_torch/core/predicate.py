"""Packed predicate-word plane: metadata filters beside the auth mask.

Role masks (core/policy.py) are one instance of filtered ANN; production
queries combine them with metadata predicates — tenant tags, freshness
windows, compliance holds, soft-deleted namespaces.  This module generalizes
the (B, W) auth-word mechanism into a second word plane: each vector carries
``P = ceil(n_bits / 32)`` packed uint32 *attribute words* whose bit layout a
:class:`PredicateSchema` declares, and a query's ``where`` clause compiles to
(require, forbid) word rows evaluated in-kernel next to the auth check
(DESIGN.md §Hybrid Filtered Search).

Encoding:
  * categorical *tag fields* map each tag to one bit position — a vector sets
    the bit for every tag it carries,
  * bucketed *range fields* use thermometer coding over declared bucket
    edges: bit ``j`` is set iff ``value >= edges[j]``.  Then ``value >= t``
    is a single require bit, ``value < t`` a single forbid bit, and a window
    ``[lo, hi)`` is require(lo) AND forbid(hi) — any conjunction of range
    atoms stays one (require, forbid) word pair.

A vector passes iff, in every word,
    (attr & require) == require   AND   (attr & forbid) == 0
— the same shape as the auth compare, so the kernel evaluates both planes in
one pass with P statically unrolled (P = 0 takes the exact pre-predicate
code path).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

PRED_WORD_BITS = 32

# ``where`` clauses are conjunctions of atoms:
#   ("has", field, tag)    — tag field: vector must carry the tag
#   ("lacks", field, tag)  — tag field: vector must not carry the tag
#   ("ge", field, edge)    — range field: value >= edge (a declared edge)
#   ("lt", field, edge)    — range field: value <  edge (a declared edge)
WhereAtom = Tuple[str, str, Union[str, float, int]]
Where = Tuple[WhereAtom, ...]


def pred_words(n_bits: int) -> int:
    """Attribute-plane width in uint32 words for ``n_bits`` schema bits."""
    return max(1, -(-int(n_bits) // PRED_WORD_BITS))


@dataclasses.dataclass(frozen=True)
class PredicateSchema:
    """Immutable bit-layout declaration for the attribute-word plane.

    Attributes:
      tag_fields: ``(field, (tag, ...))`` pairs — each tag gets one bit, in
        declaration order.
      range_fields: ``(field, (edge, ...))`` pairs — each field gets a
        contiguous run of ``len(edges)`` thermometer bits (edges ascending).
    """

    tag_fields: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    range_fields: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()

    @classmethod
    def make(cls, tags: Optional[Mapping[str, Sequence[str]]] = None,
             ranges: Optional[Mapping[str, Sequence[float]]] = None
             ) -> "PredicateSchema":
        """Build a schema from plain dicts (declaration order preserved)."""
        return cls(
            tag_fields=tuple((f, tuple(ts)) for f, ts in (tags or {}).items()),
            range_fields=tuple((f, tuple(float(e) for e in es))
                               for f, es in (ranges or {}).items()))

    def __post_init__(self):
        seen = set()
        for f, _ in self.tag_fields + self.range_fields:
            if f in seen:
                raise ValueError(f"duplicate predicate field {f!r}")
            seen.add(f)
        for f, edges in self.range_fields:
            if not edges:
                raise ValueError(f"range field {f!r} declares no edges")
            if any(b <= a for a, b in zip(edges, edges[1:])):
                raise ValueError(
                    f"range field {f!r} edges must be strictly ascending")

    # -------------------------------------------------------------- bit layout
    @property
    def n_bits(self) -> int:
        return (sum(len(ts) for _, ts in self.tag_fields)
                + sum(len(es) for _, es in self.range_fields))

    @property
    def n_words(self) -> int:
        """Attribute-plane width P in packed uint32 words."""
        if self.n_bits == 0:
            return 0
        return pred_words(self.n_bits)

    def _layout(self) -> Dict[str, Tuple[str, int, Tuple, ...]]:
        """field -> ("tag"|"range", first_bit, tags_or_edges)."""
        out: Dict[str, Tuple] = {}
        bit = 0
        for f, ts in self.tag_fields:
            out[f] = ("tag", bit, ts)
            bit += len(ts)
        for f, es in self.range_fields:
            out[f] = ("range", bit, es)
            bit += len(es)
        return out

    def bit_of(self, field: str, value) -> int:
        """Bit position of a tag, or of a range edge (exact edge required —
        bucketed coding cannot express thresholds between edges)."""
        kind, first, domain = self._entry(field)
        if kind == "tag":
            if value not in domain:
                raise ValueError(f"unknown tag {value!r} for field {field!r}")
            return first + domain.index(value)
        edge = float(value)
        for j, e in enumerate(domain):
            if e == edge:
                return first + j
        raise ValueError(
            f"{edge} is not a declared edge of range field {field!r} "
            f"(edges: {domain}); thresholds must land on bucket edges")

    def _entry(self, field: str):
        entry = self._layout().get(field)
        if entry is None:
            raise ValueError(f"unknown predicate field {field!r}")
        return entry

    # ---------------------------------------------------------------- encoding
    def encode(self, attrs: Mapping[str, object]) -> np.ndarray:
        """Pack one vector's attributes into ``(P,)`` uint32 words.

        Tag fields take a single tag or an iterable of tags; range fields a
        numeric value (thermometer: bit j set iff value >= edges[j]).  Fields
        absent from ``attrs`` contribute no bits.
        """
        words = np.zeros(self.n_words, dtype=np.uint32)
        layout = self._layout()
        for field, value in attrs.items():
            kind, first, domain = layout.get(field) or self._entry(field)
            if kind == "tag":
                tags = [value] if isinstance(value, str) else list(value)
                for t in tags:
                    if t not in domain:
                        raise ValueError(
                            f"unknown tag {t!r} for field {field!r}")
                    _set_bit(words, first + domain.index(t))
            else:
                v = float(value)
                for j, e in enumerate(domain):
                    if v >= e:
                        _set_bit(words, first + j)
        return words

    def encode_rows(self, rows: Sequence[Mapping[str, object]]) -> np.ndarray:
        """Pack ``N`` attribute dicts into an ``(N, P)`` uint32 plane."""
        if not len(rows):
            return np.zeros((0, self.n_words), dtype=np.uint32)
        return np.stack([self.encode(r) for r in rows])

    # ------------------------------------------------------------- compilation
    def compile_where(self, where: Optional[Where]
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Compile a conjunction of atoms to ``(require, forbid)`` word rows.

        Returns ``None`` for an empty/absent clause (the unfiltered path).  A
        bit demanded by both sides is unsatisfiable — a hard error, never a
        silent empty result.
        """
        if not where:
            return None
        require = np.zeros(self.n_words, dtype=np.uint32)
        forbid = np.zeros(self.n_words, dtype=np.uint32)
        for atom in where:
            try:
                op, field, value = atom
            except (TypeError, ValueError):
                raise ValueError(f"malformed where atom {atom!r}") from None
            if op in ("has", "ge"):
                _set_bit(require, self.bit_of(field, value))
            elif op in ("lacks", "lt"):
                _set_bit(forbid, self.bit_of(field, value))
            else:
                raise ValueError(f"unknown where op {op!r} in atom {atom!r}")
        if (require & forbid).any():
            raise ValueError(
                f"unsatisfiable where clause {where!r}: a bit is both "
                f"required and forbidden")
        return require, forbid


def _set_bit(words: np.ndarray, bit: int) -> None:
    words[bit // PRED_WORD_BITS] |= (
        np.uint32(1) << np.uint32(bit % PRED_WORD_BITS))


def predicate_pass(attr_words: np.ndarray, require: np.ndarray,
                   forbid: np.ndarray) -> np.ndarray:
    """Vectorized host-side pass mask — the brute-force predicate oracle.

    ``attr_words`` is ``(N, P)``; returns ``(N,)`` bool:
    every word satisfies ``(a & require) == require`` and ``(a & forbid) == 0``.
    """
    a = np.asarray(attr_words, dtype=np.uint32)
    if a.ndim == 1:
        a = a[:, None]
    req = np.asarray(require, dtype=np.uint32).reshape(1, -1)
    forb = np.asarray(forbid, dtype=np.uint32).reshape(1, -1)
    return (((a & req) == req) & ((a & forb) == 0)).all(axis=1)


def bit_population(attr_words: np.ndarray, n_words: int) -> np.ndarray:
    """Per-bit set counts over an ``(N, P)`` plane — ``(P * 32,)`` int64.

    The selectivity estimator's sufficient statistic; dynamic stores maintain
    it incrementally on insert/delete (DESIGN.md §Hybrid Filtered Search).
    """
    counts = np.zeros(int(n_words) * PRED_WORD_BITS, dtype=np.int64)
    a = np.asarray(attr_words, dtype=np.uint32)
    if a.ndim == 1:
        a = a[:, None]
    for w in range(min(a.shape[1], n_words)):
        col = a[:, w]
        for b in range(PRED_WORD_BITS):
            counts[w * PRED_WORD_BITS + b] = int(
                ((col >> np.uint32(b)) & np.uint32(1)).sum())
    return counts


def row_bits(words: np.ndarray) -> np.ndarray:
    """Unpack one ``(P,)`` word row to a ``(P * 32,)`` 0/1 vector."""
    w = np.asarray(words, dtype=np.uint32).reshape(-1)
    shifts = np.arange(PRED_WORD_BITS, dtype=np.uint32)
    return ((w[:, None] >> shifts[None, :]) & np.uint32(1)).reshape(-1)


def estimate_selectivity(require: np.ndarray, forbid: np.ndarray,
                         bit_counts: np.ndarray, n: int) -> float:
    """Independence-model selectivity of a compiled (require, forbid) pair.

    Each required bit contributes its marginal frequency ``count/n``; each
    forbidden bit ``1 - count/n``; the conjunction multiplies marginals
    (thermometer bits are correlated, so this is an estimate, not a bound).
    Clipped to ``[1/n, 1]`` so the cost model's ``1/selectivity`` inflation
    stays finite.
    """
    n = max(int(n), 1)
    freq = np.clip(np.asarray(bit_counts, dtype=np.float64) / n, 0.0, 1.0)
    sel = 1.0
    for b in np.flatnonzero(row_bits(require)):
        sel *= freq[b] if b < len(freq) else 0.0
    for b in np.flatnonzero(row_bits(forbid)):
        sel *= (1.0 - freq[b]) if b < len(freq) else 1.0
    return float(np.clip(sel, 1.0 / n, 1.0))

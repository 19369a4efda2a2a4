"""Predicate filters over an index's external id space (port of
``repro.filter.filter``, DESIGN.md §16).

A :class:`Filter` is an immutable boolean bitmap aligned with the
external ids of an index — ``mask[ext_id]`` says whether that row may be
returned.  It sits *below* the index layer: every kind pushes the bitmap,
moved to the index's device once at plan time, into the engine's
pad / tombstone id-masking (the ``gid < n_valid`` fence of the plain scan
and the mask argument of the kernels B2-B5), so a filter costs one mask
test per scored row, never a [Q, N] rescan.

A Filter hashes and compares by a content digest of its bitmap (blake2b
over the row count and the packed bits, as the reference computes it), so
the same mask has the same hex digest in both packages.

Construction:

    f = Filter.from_mask(mask)                 # you already have the bitmap
    f = Filter.from_ids([3, 17, 99], n)        # allow-list of external ids
    f = Filter.from_column(cats, 7)            # cats[i] == 7
    f = Filter.from_column(cats, {2, 7})       # cats[i] in {2, 7}
    f = Filter.from_predicate(prices, lambda p: p < 30.0, n)

and composes as a boolean algebra: ``f & g``, ``f | g``, ``~f``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Iterable

import numpy as np


def _freeze(mask: np.ndarray) -> np.ndarray:
    out = np.ascontiguousarray(np.asarray(mask, dtype=bool))
    if out.ndim != 1:
        raise ValueError(f"filter mask must be 1-D, got shape {out.shape}")
    out.setflags(write=False)
    return out


def _digest(mask: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(mask.shape[0]).tobytes())
    h.update(np.packbits(mask).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Filter:
    """Immutable allow-bitmap over external row ids.

    ``mask[i]`` is True iff external id ``i`` may appear in results.
    Equality and hashing go through ``digest`` (content, not identity),
    so a Filter is a valid member of frozen ``SearchParams`` and of
    compiled-plan / result-cache keys.
    """

    mask: np.ndarray
    digest: str

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_mask(mask) -> "Filter":
        m = _freeze(mask)
        return Filter(m, _digest(m))

    @staticmethod
    def from_ids(ids: Iterable[int], n: int) -> "Filter":
        """Allow-list: only these external ids survive."""
        m = np.zeros(int(n), dtype=bool)
        idx = np.asarray(list(ids), dtype=np.int64)
        if idx.size:
            if idx.min() < 0 or idx.max() >= n:
                raise ValueError(
                    f"filter ids must lie in [0, {n}), got range "
                    f"[{idx.min()}, {idx.max()}]"
                )
            m[idx] = True
        return Filter.from_mask(m)

    @staticmethod
    def from_column(column, value: Any) -> "Filter":
        """Equality / membership over a per-row metadata column.

        ``value`` may be a scalar (``column == value``) or a
        set/list/tuple/array (``column ∈ value``).
        """
        col = np.asarray(column)
        if col.ndim != 1:
            raise ValueError(
                f"metadata column must be 1-D, got shape {col.shape}"
            )
        if isinstance(value, (set, frozenset, list, tuple, np.ndarray)):
            vals = np.asarray(sorted(value) if isinstance(
                value, (set, frozenset)) else value)
            return Filter.from_mask(np.isin(col, vals))
        return Filter.from_mask(col == value)

    @staticmethod
    def from_predicate(column, pred: Callable[[np.ndarray], np.ndarray],
                       n: int | None = None) -> "Filter":
        """Arbitrary vectorized predicate over a metadata column."""
        col = np.asarray(column)
        m = np.asarray(pred(col), dtype=bool)
        if m.shape != col.shape:
            raise ValueError(
                f"predicate must return one bool per row: column "
                f"{col.shape} -> mask {m.shape}"
            )
        if n is not None and m.shape[0] != n:
            raise ValueError(
                f"filter covers {m.shape[0]} rows but index has {n}"
            )
        return Filter.from_mask(m)

    # -- interrogation -----------------------------------------------------

    @property
    def n(self) -> int:
        return int(self.mask.shape[0])

    @property
    def count(self) -> int:
        """Number of surviving (allowed) rows."""
        return int(self.mask.sum())

    @property
    def selectivity(self) -> float:
        """Fraction of rows that survive (1.0 = filter-none)."""
        return self.count / self.n if self.n else 1.0

    def ids(self) -> np.ndarray:
        """The surviving external ids, ascending."""
        return np.flatnonzero(self.mask)

    def aligned(self, n: int) -> np.ndarray:
        """The bitmap resized to an index of ``n`` rows.

        Rows the filter never saw (appended after it was built, e.g.
        stream upserts past the bitmap's horizon) default to *allowed* —
        a filter constrains what it describes, it does not veto unknown
        rows.  Shrinking just truncates.
        """
        if n == self.n:
            return self.mask
        if n < self.n:
            return self.mask[:n]
        return np.concatenate(
            [self.mask, np.ones(n - self.n, dtype=bool)]
        )

    # -- boolean algebra ---------------------------------------------------

    def _binop(self, other: "Filter", op) -> "Filter":
        if not isinstance(other, Filter):
            return NotImplemented
        if other.n != self.n:
            raise ValueError(
                f"cannot compose filters over different id spaces "
                f"({self.n} vs {other.n} rows)"
            )
        return Filter.from_mask(op(self.mask, other.mask))

    def __and__(self, other: "Filter") -> "Filter":
        return self._binop(other, np.logical_and)

    def __or__(self, other: "Filter") -> "Filter":
        return self._binop(other, np.logical_or)

    def __invert__(self) -> "Filter":
        return Filter.from_mask(~self.mask)

    # -- identity ----------------------------------------------------------

    def __hash__(self) -> int:
        return hash((self.n, self.digest))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Filter):
            return NotImplemented
        return self.n == other.n and self.digest == other.digest

    def __repr__(self) -> str:
        return (f"Filter(n={self.n}, count={self.count}, "
                f"selectivity={self.selectivity:.3f}, "
                f"digest={self.digest[:8]})")


def overfetch(k: int, selectivity: float, n: int) -> int:
    """Candidate depth to request so ~k survivors remain post-filter.

    The engine masks *inside* the scan, so exact kinds don't need this —
    they see every row.  It exists for the candidate-generating kinds
    (graph walks, per-segment over-fetch, a rerank depth): to keep k
    survivors when only a ``selectivity`` fraction of candidates pass,
    fetch ``k/selectivity`` plus a safety margin of 8, clamped to the
    corpus: ``min(n, max(k, ceil(k / sel) + 8))``.  Selectivity 0
    (filter-all) clamps to n: the oracle answer is "all pad", reached by
    scanning everything and finding no survivor.  (The reference returns
    ``max(k, min(want, n))``, which exceeds n when k > n, against its own
    docstring; the port follows the docstring.)
    """
    if selectivity >= 1.0:
        return min(k, n) if n else k
    sel = max(float(selectivity), 1e-9)
    want = int(np.ceil(k / sel)) + 8
    return min(n, max(k, want))

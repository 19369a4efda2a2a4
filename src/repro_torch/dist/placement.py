"""Placement plans: which shard owns which rows / lists / segments (port of
``repro.dist.placement``, DESIGN.md §15).

A ``Placement`` is the host-side half of a sharded search plan: a frozen
assignment of an index's natural shard units to mesh shards, computed at
plan time and pinned by the ``Searcher`` the same way tune tables are.
The unit depends on the kind:

  * ``rows``       — flat / pq scans: contiguous row blocks, one per shard
                     (block order == gid order, so the cross-shard merge's
                     shard-major gather is already in canonical id order).
  * ``lists``      — ivf: whole IVF lists, balanced by list *size* (LPT
                     greedy), so a skewed clustering cannot pile the big
                     lists onto one device.
  * ``segments``   — stream: a sealed segment is a natural shard unit with
                     its own row-id base; the memtable rides as one more
                     unit.  (The compiled plan shards each source over the
                     full mesh — see DESIGN.md §15 — this placement is the
                     accounting view: per-shard bytes, balance, telemetry.)
  * ``replicated`` — graph walks (hnsw/graph): the structure is not
                     row-shardable, so every shard holds a full copy and
                     queries fan out over the mesh instead (dist.replica).

Everything here is plain host Python over ints, so plans can be printed,
logged and asserted on without touching a device.  The port keeps its own
copy; its output equals the reference's for every input.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["Placement", "balance", "for_index"]


def balance(sizes: Sequence[int], n_shards: int) -> tuple[int, ...]:
    """LPT greedy assignment: units sorted by size (desc) land on the
    currently-least-loaded shard.  Deterministic — ties in size break by
    unit id, ties in load break by shard id — so the same inputs always
    produce the same placement (plans must be reproducible across
    processes to keep replica groups consistent)."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    loads = [0] * n_shards
    assign = [0] * len(sizes)
    order = sorted(range(len(sizes)), key=lambda u: (-int(sizes[u]), u))
    for u in order:
        s = min(range(n_shards), key=lambda j: (loads[j], j))
        assign[u] = s
        loads[s] += int(sizes[u])
    return tuple(assign)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A frozen unit -> shard assignment.

    ``assign[u]`` is the shard owning unit ``u``; ``unit_sizes[u]`` is
    that unit's row count.  ``kind`` names the unit type (see module
    docstring).  For ``replicated`` placements ``assign`` is empty —
    every shard holds everything.
    """

    kind: str
    n_shards: int
    assign: tuple[int, ...]
    unit_sizes: tuple[int, ...]
    #: only for ``replicated`` placements, which have no units: the row
    #: count every shard holds a full copy of
    replicated_rows: int = 0

    def __post_init__(self):
        if self.kind not in ("rows", "lists", "segments", "replicated"):
            raise ValueError(f"unknown placement kind {self.kind!r}")
        if len(self.assign) != len(self.unit_sizes):
            raise ValueError("assign and unit_sizes must align")
        if any(not (0 <= s < self.n_shards) for s in self.assign):
            raise ValueError("assign references a shard outside the mesh")

    # -- views -------------------------------------------------------------
    @property
    def n_units(self) -> int:
        return len(self.assign)

    @property
    def n_rows(self) -> int:
        if self.kind == "replicated":
            return self.replicated_rows
        return sum(self.unit_sizes)

    def shard_units(self, shard: int) -> tuple[int, ...]:
        """Unit ids owned by ``shard``, in unit order."""
        return tuple(u for u, s in enumerate(self.assign) if s == shard)

    def shard_rows(self, shard: int) -> int:
        if self.kind == "replicated":
            return self.n_rows
        return sum(self.unit_sizes[u] for u in self.shard_units(shard))

    @property
    def rows_max(self) -> int:
        """Rows on the fullest shard — the padded per-shard extent the
        compiled plan allocates, and the number that must fit one
        device's budget."""
        return max(self.shard_rows(s) for s in range(self.n_shards))

    def shard_bytes(self, row_bytes: int) -> tuple[int, ...]:
        """Per-shard resident code bytes (telemetry: shard scan bytes)."""
        return tuple(self.shard_rows(s) * int(row_bytes)
                     for s in range(self.n_shards))

    def summary(self) -> dict:
        rows = [self.shard_rows(s) for s in range(self.n_shards)]
        total = sum(rows) or 1
        return {
            "kind": self.kind,
            "n_shards": self.n_shards,
            "n_units": self.n_units,
            "rows": rows,
            # balance: fullest shard vs the perfectly-even split (1.0 ==
            # perfect; replicated placements report n_shards by design)
            "balance": round(max(rows) * self.n_shards / total, 4),
        }

    # -- factories ---------------------------------------------------------
    @classmethod
    def rows(cls, n: int, n_shards: int) -> "Placement":
        """Contiguous ceil-sized row blocks, shard s owning rows
        ``[s*rows_per, min((s+1)*rows_per, n))``: the layout
        ``sharded_scan_plan`` scans."""
        rows_per = -(-n // n_shards) if n else 0
        sizes = tuple(max(0, min(n - s * rows_per, rows_per))
                      for s in range(n_shards))
        return cls("rows", n_shards, tuple(range(n_shards)), sizes)

    @classmethod
    def lists(cls, list_sizes: Sequence[int], n_shards: int) -> "Placement":
        sizes = tuple(int(x) for x in list_sizes)
        return cls("lists", n_shards, balance(sizes, n_shards), sizes)

    @classmethod
    def segments(cls, segment_rows: Sequence[int], n_shards: int) -> "Placement":
        sizes = tuple(int(x) for x in segment_rows)
        return cls("segments", n_shards, balance(sizes, n_shards), sizes)

    @classmethod
    def replicated(cls, n_rows: int, n_shards: int) -> "Placement":
        return cls("replicated", n_shards, (), (), replicated_rows=int(n_rows))


def for_index(index, n_shards: int) -> Placement:
    """The placement an index kind elects for an ``n_shards`` mesh.

    Kinds expose a ``placement(n_shards)`` method (ivf -> lists, stream
    -> segments, graph walks -> replicated); anything without one gets
    the contiguous row-block default.
    """
    own = getattr(index, "placement", None)
    if callable(own):
        return own(n_shards)
    return Placement.rows(int(index.n), n_shards)

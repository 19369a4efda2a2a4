"""The write buffer of the mutable index: a host-side fp32 memtable (port
of ``repro.stream.memtable``, pure numpy, as the reference's).

Writes land here first (LSM style): ``upsert`` appends rows and
shadow-kills any previous row with the same external id, ``delete``
kills in place.  Rows live in insertion order — the order sealing and
compaction preserve, which is what makes the exact-parity property
(compact-everything == from-scratch build on the surviving rows in
arrival order) well-defined.

The memtable is deliberately plain numpy: it is the *mutable* half of
the subsystem, touched on every write — search snapshots its live rows
into an ``engine.CodeStore`` on the index's device at plan time
(DESIGN.md §10).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

_INT32_MAX = np.iinfo(np.int32).max


def as_id_array(ids: Iterable[int]) -> np.ndarray:
    """Validate external ids: 1-D, non-negative, int32-representable
    (device id maps are int32; -1 is the engine's no-hit sentinel)."""
    out = np.asarray(ids, dtype=np.int64).reshape(-1)
    if out.size and (out.min() < 0 or out.max() > _INT32_MAX):
        raise ValueError(
            "external ids must be in [0, 2^31); -1 is reserved as the "
            f"no-hit sentinel (got range [{out.min()}, {out.max()}])"
        )
    return out


class Memtable:
    """Append-only fp32 row buffer with shadow-kill upsert semantics."""

    def __init__(self, d: int, threshold: int = 4096):
        if threshold <= 0:
            raise ValueError(f"seal threshold must be positive, got {threshold}")
        self.d = int(d)
        self.threshold = int(threshold)
        self.clear()

    def clear(self) -> None:
        self._vecs = np.empty((0, self.d), np.float32)
        self._ids = np.empty((0,), np.int64)
        self._live = np.empty((0,), bool)
        self._pos: dict[int, int] = {}          # ext id -> live row

    # -- accounting --------------------------------------------------------
    @property
    def rows(self) -> int:
        """Buffered rows including shadow-killed ones."""
        return int(self._ids.shape[0])

    @property
    def live_count(self) -> int:
        return len(self._pos)

    @property
    def full(self) -> bool:
        """Seal trigger: *buffered* rows, not live rows — a replace-heavy
        workload (hot keys upserted over and over) keeps live_count tiny
        while shadow-killed rows pile up, and the buffer budget is what
        bounds host memory.  Sealing drops the shadowed rows."""
        return self.rows >= self.threshold

    def memory_bytes(self) -> int:
        return int(self._vecs.nbytes + self._ids.nbytes + self._live.nbytes)

    def __contains__(self, ext_id: int) -> bool:
        return int(ext_id) in self._pos

    # -- writes ------------------------------------------------------------
    def upsert(self, ids, vectors) -> np.ndarray:
        """Append (id, vector) rows, shadow-killing any older memtable row
        with the same id.  Returns the validated id batch; tombstoning
        copies of these ids that live in *sealed segments* is the
        caller's job (MutableIndex.upsert does both)."""
        ids = as_id_array(ids)
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.d:
            raise ValueError(
                f"vectors must be [m, {self.d}], got {tuple(vectors.shape)}"
            )
        if ids.shape[0] != vectors.shape[0]:
            raise ValueError(
                f"{ids.shape[0]} ids for {vectors.shape[0]} vectors"
            )
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids within one upsert batch")
        start = self.rows
        self._vecs = np.concatenate([self._vecs, vectors])
        self._ids = np.concatenate([self._ids, ids])
        self._live = np.concatenate([self._live, np.ones(ids.size, bool)])
        for off, ext in enumerate(ids.tolist()):
            old = self._pos.get(ext)
            if old is not None:                 # shadow-kill the old row
                self._live[old] = False
            self._pos[ext] = start + off
        return ids

    def delete(self, ids) -> int:
        """Kill live memtable rows for these ids; returns how many hit."""
        hit = 0
        for ext in as_id_array(ids).tolist():
            row = self._pos.pop(ext, None)
            if row is not None:
                self._live[row] = False
                hit += 1
        return hit

    # -- reads -------------------------------------------------------------
    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors [m, d] f32, ext_ids [m] i64) of live rows, insertion
        order — the seal/compaction/search view."""
        mask = self._live
        return self._vecs[mask].copy(), self._ids[mask].copy()

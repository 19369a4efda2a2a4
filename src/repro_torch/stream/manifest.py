"""The manifest: the authoritative record of a mutable index's segments
(port of ``repro.stream.manifest``, pure numpy bookkeeping).

LSM bookkeeping in one place: the ordered segment list (order fixes the
internal id space — segment j's rows live at ``base_j .. base_j+n_j-1``
with ``base_j = sum(n_i, i<j)``), the tombstone totals, an ``epoch``
counter bumped on every structural change (seal / compact / load) so
planned Searchers can tell they are stale, and the (arrays, meta)
assembly that drives save/load.  Deletes fan out to every segment's
tombstone bitmap through here.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from repro_torch.stream.segment import Segment


class Manifest:
    def __init__(self, segments: Iterable[Segment] = ()):
        self.segments: list[Segment] = list(segments)
        self.epoch = 0

    def bump(self) -> None:
        self.epoch += 1

    # -- id space ----------------------------------------------------------
    def bases(self) -> list[int]:
        out, base = [], 0
        for seg in self.segments:
            out.append(base)
            base += seg.n
        return out

    @property
    def total_rows(self) -> int:
        return sum(seg.n for seg in self.segments)

    @property
    def live_rows(self) -> int:
        return sum(seg.live_count for seg in self.segments)

    @property
    def tombstones(self) -> int:
        return sum(seg.dead_count for seg in self.segments)

    def memory_bytes(self) -> int:
        return sum(seg.memory_bytes() for seg in self.segments)

    # -- mutation ----------------------------------------------------------
    def add(self, segment: Segment) -> None:
        self.segments.append(segment)
        self.bump()

    def replace(self, old: list[Segment], new: list[Segment]) -> None:
        """Swap a compacted group for its merged result, preserving the
        position of the group's first member (id-space order stays the
        arrival order of the surviving rows)."""
        if not old:
            raise ValueError("empty compaction group")
        at = self.segments.index(old[0])
        keep = [s for s in self.segments if s not in old]
        self.segments = keep[:at] + list(new) + keep[at:]
        self.bump()

    def delete(self, ids) -> int:
        """Tombstone ``ids`` in every segment; returns rows killed."""
        hit = 0
        for seg in self.segments:
            hit += seg.delete(ids)
        if hit:
            self.bump()
        return hit

    # -- concatenated segment-side views (search-plan assembly) ------------
    def id_map(self) -> np.ndarray:
        if not self.segments:
            return np.empty((0,), np.int64)
        return np.concatenate([seg.ext_ids for seg in self.segments])

    def live_map(self) -> np.ndarray:
        if not self.segments:
            return np.empty((0,), bool)
        return np.concatenate([seg.live for seg in self.segments])

    def raw_concat(self) -> np.ndarray:
        """All segment payloads stacked in id-space order (merge store)."""
        return np.concatenate([seg.raw for seg in self.segments])

    # -- disk round-trip ---------------------------------------------------
    def state(self) -> tuple[dict[str, Any], dict[str, Any]]:
        arrays: dict[str, Any] = {}
        meta: dict[str, Any] = {"n_segments": len(self.segments)}
        for i, seg in enumerate(self.segments):
            a, m = seg.state(f"seg{i}_")
            arrays.update(a)
            meta.update(m)
        return arrays, meta

    @staticmethod
    def from_state(arrays, meta, device=None) -> "Manifest":
        return Manifest(
            Segment.from_state(arrays, meta, f"seg{i}_", device=device)
            for i in range(int(meta["n_segments"]))
        )

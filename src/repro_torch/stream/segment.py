"""A sealed, immutable run of the mutable index (port of
``repro.stream.segment``).

A ``Segment`` is one inner-index instance (any ported kind, built through
the ordinary registry path, on the index's device) over a frozen batch of
rows, plus what the stream layer needs around it, all host numpy as in
the reference:

  * ``raw``       the fp32 source payload, kept so compaction can
                  re-quantize and the merge store can re-score exactly;
  * ``ext_ids``   external id per row (internal ids are positional; the
                  manifest gives each segment a row-id base);
  * ``live``      the tombstone bitmap: deletes and shadowing upserts
                  flip rows dead; rows disappear only at compaction;
  * ``calib``     ``DimStats`` of the rows the quantizer was fit on (on
                  the host CPU), what ``calibration_drift`` compares with
                  the live insert distribution.
"""

from __future__ import annotations

import io
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import stats as St
from repro_torch.stream.memtable import as_id_array


def host_stats(vectors: np.ndarray) -> St.DimStats:
    """``corpus_stats`` of host rows, reduced on the CPU: the stream
    layer's statistics stay on the host whatever the index's device, so a
    write sequence makes the same drift decisions on every device."""
    return St.corpus_stats(torch.from_numpy(np.asarray(vectors, np.float32)))


class Segment:
    """Immutable rows + inner index; only the tombstone bitmap mutates."""

    def __init__(
        self,
        index: Any,
        raw: np.ndarray,
        ext_ids: np.ndarray,
        calib: St.DimStats,
        live: Optional[np.ndarray] = None,
    ):
        self.index = index
        self.raw = np.asarray(raw, np.float32)
        self.ext_ids = as_id_array(ext_ids)
        self.live = (np.ones(self.raw.shape[0], bool)
                     if live is None else np.asarray(live, bool).copy())
        self.calib = calib
        if not (self.raw.shape[0] == self.ext_ids.shape[0] == self.live.shape[0]
                == index.n):
            raise ValueError(
                f"segment row mismatch: raw={self.raw.shape[0]} "
                f"ids={self.ext_ids.shape[0]} live={self.live.shape[0]} "
                f"index.n={index.n}"
            )

    # -- construction ------------------------------------------------------
    @staticmethod
    def seal(
        vectors: np.ndarray,
        ext_ids: np.ndarray,
        inner_spec,
        *,
        key: int,
        device,
        calib: Optional[St.DimStats] = None,
    ) -> "Segment":
        """Freeze a row batch into a segment: build the inner index on
        ``device`` (it learns this segment's own Eq. 1 constants unless
        ``inner_spec`` carries pre-learned ones; ``key`` is its int seed)
        and record the calibration stats."""
        from repro_torch.knn import registry

        vectors = np.asarray(vectors, np.float32)
        index = registry.make_index(inner_spec, vectors, key=key,
                                    device=device)
        if calib is None:
            calib = host_stats(vectors)
        return Segment(index, vectors, ext_ids, calib)

    # -- accounting --------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.raw.shape[0])

    @property
    def live_count(self) -> int:
        return int(self.live.sum())

    @property
    def dead_count(self) -> int:
        return self.n - self.live_count

    def drift(self, live_stats: St.DimStats) -> float:
        """How far the live insert distribution has moved since this
        segment's quantizer was calibrated."""
        return St.calibration_drift(self.calib, live_stats)

    def memory_bytes(self) -> int:
        return int(self.index.memory_bytes()) + int(
            self.raw.nbytes + self.ext_ids.nbytes + self.live.nbytes
        )

    # -- mutation (tombstones only) ---------------------------------------
    def delete(self, ids) -> int:
        """Tombstone rows whose external id is in ``ids``; returns how
        many rows were newly killed."""
        mask = np.isin(self.ext_ids, as_id_array(ids)) & self.live
        self.live[mask] = False
        return int(mask.sum())

    def survivors(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors, ext_ids) of live rows, in segment row order."""
        return self.raw[self.live].copy(), self.ext_ids[self.live].copy()

    # -- disk round-trip fragments ----------------------------------------
    def state(self, prefix: str) -> tuple[dict[str, Any], dict[str, Any]]:
        """(arrays, meta) fragments for the manifest npz: the inner index
        is embedded as its own npz byte blob, the stream-side arrays ride
        alongside (the reference's keys)."""
        buf = io.BytesIO()
        self.index.save(buf)
        arrays = {
            f"{prefix}blob": np.frombuffer(buf.getvalue(), np.uint8),
            f"{prefix}raw": self.raw,
            f"{prefix}ids": self.ext_ids,
            f"{prefix}live": self.live,
        }
        arrays.update(St.stats_arrays(f"{prefix}cal_", self.calib))
        return arrays, {f"{prefix}seg": {"kind": self.index.kind, "n": self.n}}

    @staticmethod
    def from_state(arrays, meta, prefix: str, device=None) -> "Segment":
        from repro_torch.knn import registry

        sm = meta[f"{prefix}seg"]
        blob = io.BytesIO(np.asarray(arrays[f"{prefix}blob"]).tobytes())
        index = registry.get_impl(sm["kind"]).load(blob, device=device)
        return Segment(
            index,
            np.asarray(arrays[f"{prefix}raw"], np.float32),
            np.asarray(arrays[f"{prefix}ids"]),
            St.stats_from_arrays(f"{prefix}cal_", arrays),
            live=np.asarray(arrays[f"{prefix}live"], bool),
        )

"""Live compaction: merge small segments, drop tombstones, re-quantize
on drift (port of ``repro.stream.compactor``).

The paper's quantization is data-driven (§3.2: per-dimension Gaussian
fit -> Eq. 1 constants), so a mutating corpus decays the
metric-preserving property: a segment sealed long ago was calibrated on
a distribution the insert stream may have left behind.  The compactor is
where that is repaired — it rewrites groups of segments into one, and
chooses between two quantization paths:

  * **reuse** — every input segment carries bit-identical Eq. 1 constants
    and none has drifted past the policy threshold: the merged segment is
    rebuilt under those same constants (cheap: no re-learn; codes for
    surviving rows are numerically identical to the inputs').
  * **recalibrate** — constants differ across inputs, or
    ``calibration_drift`` (core.stats) between a segment's calibration
    and the drift-tracked ``StreamingStats`` of the insert stream exceeds
    ``drift_threshold``: fresh constants are learned from the merged
    surviving rows (the from-scratch build path, which is exactly why
    compact-everything gives bit-parity with a from-scratch index).

Tombstoned rows are physically dropped either way; surviving rows keep
arrival order, so the internal id space stays a stable arrival log.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core import stats as St
from repro_torch.stream.segment import Segment


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When to compact and when to re-quantize.

    max_segments     structural trigger: auto-compaction runs when the
                     manifest holds more than this many segments
    small_rows       segments with fewer live rows are "small" and get
                     merged first (default: the index's seal threshold)
    drift_threshold  ``calibration_drift`` above which a segment's codes
                     are considered stale and the merge re-learns Eq. 1
                     constants (~= sigmas of mean shift; see core.stats)
    """

    max_segments: int = 8
    small_rows: Optional[int] = None
    drift_threshold: float = 0.5


class Compactor:
    """Merges segment groups for a fixed inner spec (one per MutableIndex)."""

    def __init__(self, inner_factory: str, metric: str,
                 policy: CompactionPolicy,
                 inner_overrides: Optional[dict] = None, device=None):
        self.inner_factory = inner_factory
        self.metric = metric
        self.policy = policy
        self.inner_overrides = dict(inner_overrides or {})
        self.device = device

    # -- policy ------------------------------------------------------------
    def pick_group(self, segments: list[Segment]) -> list[Segment]:
        """The next group to merge: the longest *contiguous* run of small
        segments (contiguity keeps the id space an arrival log), falling
        back to the two smallest neighbors when every segment is large.
        Empty list = nothing to do."""
        if len(segments) < 2:
            return []
        small = self.policy.small_rows or 0
        best: list[Segment] = []
        run: list[Segment] = []
        for seg in segments:
            if seg.live_count < small or seg.dead_count > 0:
                run.append(seg)
            else:
                best, run = max(best, run, key=len), []
        best = max(best, run, key=len)
        if len(best) >= 2:
            return best
        # all segments large and clean: merge the adjacent pair with the
        # fewest combined live rows
        pairs = list(zip(segments, segments[1:]))
        a, b = min(pairs, key=lambda p: p[0].live_count + p[1].live_count)
        return [a, b]

    def should_compact(self, segments: list[Segment]) -> bool:
        return len(segments) > self.policy.max_segments

    # -- mechanism ---------------------------------------------------------
    def needs_recalibration(
        self, group: list[Segment], live_stats: St.DimStats
    ) -> bool:
        params = [getattr(seg.index, "params", None) for seg in group]
        from repro_torch.engine.store import _params_equal

        if not all(_params_equal(p, params[0]) for p in params):
            return True
        if float(live_stats.count) == 0.0:
            return False                      # no insert signal yet
        return any(
            seg.drift(live_stats) > self.policy.drift_threshold
            for seg in group
        )

    def freeze(
        self,
        group: list[Segment],
        *,
        live_stats: St.DimStats,
        recalibrate: Optional[bool] = None,
    ) -> "FrozenMerge | None":
        """Snapshot everything a merge needs from the (mutable) group:
        surviving rows, external ids, the recalibrate verdict, and — on
        the reuse path — the frozen constants + pooled calibration.

        This is the cheap, copy-only half of :meth:`merge`.  The caller
        holds the index's write lock across ``freeze`` and releases it
        before the expensive :meth:`build`, which is how background
        compaction stays off the request path (DESIGN.md §12): after
        ``freeze`` the merge is a pure function of the snapshot, immune
        to concurrent tombstones (those are re-applied at swap time).
        """
        from repro_torch.knn.spec import parse_factory

        if recalibrate is None:
            recalibrate = self.needs_recalibration(group, live_stats)

        vecs = [v for v, _ in (seg.survivors() for seg in group)]
        ids = [seg.ext_ids[seg.live] for seg in group]
        vectors = np.concatenate(vecs)
        ext_ids = np.concatenate(ids)
        if vectors.shape[0] == 0:
            return None

        spec = parse_factory(self.inner_factory, metric=self.metric)
        if self.inner_overrides:
            spec = spec.with_overrides(**self.inner_overrides)
        calib = None
        if not recalibrate:
            params = getattr(group[0].index, "params", None)
            if params is not None:
                if spec.quant is None:
                    raise ValueError("quantized segments under an fp32 spec")
                spec = dataclasses.replace(
                    spec, quant=spec.quant.with_params(params)
                )
            # constants unchanged -> the calibration provenance is the
            # pooled calibration of the inputs, not the merged rows
            calib = group[0].calib
            for seg in group[1:]:
                calib = St.merge_stats(calib, seg.calib)
        return FrozenMerge(vectors, ext_ids, spec, calib, bool(recalibrate))

    def build(self, frozen: "FrozenMerge", *, key: int) -> Segment:
        """The expensive half: seal the frozen rows into the merged
        segment on the compactor's device (inner-index build, possibly
        re-learning Eq. 1 constants; B1 encodes on the card).  Pure with
        respect to the live index: safe to run off the write lock."""
        return Segment.seal(frozen.vectors, frozen.ext_ids, frozen.spec,
                            key=key, device=self.device, calib=frozen.calib)

    def merge(
        self,
        group: list[Segment],
        *,
        live_stats: St.DimStats,
        key: int,
        recalibrate: Optional[bool] = None,
    ) -> tuple[Optional[Segment], bool]:
        """Merge a segment group into one (None if nothing survives).

        Returns (segment, recalibrated).  ``recalibrate=None`` lets the
        drift policy decide (reuse only happens when the group shares
        bit-identical constants and nothing drifted); True forces a
        fresh fit (the full-compaction / exact-parity path); False
        forces reuse of ``group[0]``'s constants even across a
        mixed-constant group — deliberately unchecked, it is the
        stale-compaction arm ``bench_stream`` measures recall decay on.

        ``merge`` == ``freeze`` + ``build`` done synchronously; the
        background path calls the halves separately.
        """
        if recalibrate is None:
            recalibrate = self.needs_recalibration(group, live_stats)
        frozen = self.freeze(group, live_stats=live_stats,
                             recalibrate=recalibrate)
        if frozen is None:
            return None, bool(recalibrate)
        return self.build(frozen, key=key), frozen.recalibrated


@dataclasses.dataclass(frozen=True)
class FrozenMerge:
    """The lock-free snapshot a merge is built from (see ``freeze``)."""

    vectors: np.ndarray
    ext_ids: np.ndarray
    spec: Any
    calib: Optional[St.DimStats]
    recalibrated: bool

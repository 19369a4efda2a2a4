"""Per-dimension corpus statistics for data-driven quantization (paper §3.2);
port of ``repro.core.stats``: the one-shot collector ``corpus_stats``,
the Chan / Welford parallel merge ``merge_stats`` and its streaming holder
``StreamingStats``, the ``calibration_drift`` scalar the stream compactor
reads, and the npz fragments of a ``DimStats``.  The distributed
collector waits for ROADMAP queue A14.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DimStats:
    """Per-dimension first/second moments + range of a corpus."""

    count: torch.Tensor   # scalar f32 number of rows seen
    mean: torch.Tensor    # [d]
    m2: torch.Tensor      # [d] sum of squared deviations
    amax: torch.Tensor    # [d] max |x|
    vmin: torch.Tensor    # [d]
    vmax: torch.Tensor    # [d]

    @property
    def var(self) -> torch.Tensor:
        return self.m2 / torch.clamp_min(self.count, 1.0)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var)

    def uniform(self) -> "DimStats":
        """Collapse to a single (mu, sigma) across dims (paper §4.1); the
        pooled variance includes the between-dimension spread of means."""
        pooled_mean = torch.mean(self.mean)
        cnt = torch.clamp_min(self.count, 1.0)
        ex2 = self.m2 / cnt + self.mean ** 2
        pooled_var = torch.clamp_min(torch.mean(ex2) - pooled_mean ** 2, 0.0)
        full = torch.ones_like(self.mean)
        return DimStats(
            count=self.count,
            mean=full * pooled_mean,
            m2=full * pooled_var * cnt,
            amax=full * torch.max(self.amax),
            vmin=full * torch.min(self.vmin),
            vmax=full * torch.max(self.vmax),
        )


def empty_stats(d: int, dtype=torch.float32, device=None) -> DimStats:
    """Zero rows seen (the identity of a moment merge)."""
    zero = torch.zeros((d,), dtype=dtype, device=device)
    return DimStats(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=zero,
        m2=zero,
        amax=zero,
        vmin=torch.full((d,), float("inf"), dtype=dtype, device=device),
        vmax=torch.full((d,), float("-inf"), dtype=dtype, device=device),
    )


def corpus_stats(x: torch.Tensor) -> DimStats:
    """One-shot per-dimension stats of a [N, d] corpus (an empty batch
    returns ``empty_stats``, never NaN moments)."""
    x = x.to(torch.float32)
    if x.shape[0] == 0:
        return empty_stats(x.shape[1], x.dtype, x.device)
    mean = torch.mean(x, dim=0)
    m2 = torch.sum((x - mean) ** 2, dim=0)
    return DimStats(
        count=torch.tensor(float(x.shape[0]), dtype=torch.float32,
                           device=x.device),
        mean=mean,
        m2=m2,
        amax=torch.amax(torch.abs(x), dim=0),
        vmin=torch.amin(x, dim=0),
        vmax=torch.amax(x, dim=0),
    )


def merge_stats(a: DimStats, b: DimStats) -> DimStats:
    """Chan et al. parallel merge of two partial moment sets.

    Zero-count safe: merging an empty collector (count == 0) is the
    identity; the empty side's placeholder moments are masked out of the
    mean and the cross-term, so they never surface as NaN."""
    n = a.count + b.count
    safe_n = torch.clamp_min(n, 1.0)
    a_mean = torch.where(a.count > 0, a.mean, 0.0)
    b_mean = torch.where(b.count > 0, b.mean, 0.0)
    delta = b_mean - a_mean
    both = (a.count > 0) & (b.count > 0)
    mean = torch.where(
        both,
        a_mean + delta * (b.count / safe_n),
        torch.where(b.count > 0, b_mean, a_mean),
    )
    m2 = (
        torch.where(a.count > 0, a.m2, 0.0)
        + torch.where(b.count > 0, b.m2, 0.0)
        + torch.where(both, delta ** 2 * (a.count * b.count / safe_n), 0.0)
    )
    return DimStats(
        count=n,
        mean=mean,
        m2=m2,
        amax=torch.maximum(a.amax, b.amax),
        vmin=torch.minimum(a.vmin, b.vmin),
        vmax=torch.maximum(a.vmax, b.vmax),
    )


def calibration_drift(calib: DimStats, live: DimStats) -> float:
    """How far a quantizer's calibration has drifted from the live corpus:
    the mean over dimensions of the mean shift in live-sigma units plus
    the absolute log std ratio,

        drift = mean_i ( |mu_c - mu_l| / sigma_l + |log(sigma_c / sigma_l)| ),

    0 when the distributions match, about s after an s-sigma mean shift.
    +inf when either side is empty.  The stream compactor re-quantizes a
    segment when this exceeds its threshold (DESIGN.md §10)."""
    if float(calib.count) == 0.0 or float(live.count) == 0.0:
        return float("inf")
    sd_l = torch.clamp_min(live.std, 1e-12)
    sd_c = torch.clamp_min(calib.std.to(sd_l.device), 1e-12)
    dmu = torch.abs(calib.mean.to(sd_l.device) - live.mean) / sd_l
    dsd = torch.abs(torch.log(sd_c / sd_l))
    return float(torch.mean(dmu + dsd))


# -- DimStats <-> npz fragments (the stream segments' calibration and the
# manifest's live stats; shape-agnostic field maps, as the reference's) ----

STATS_FIELDS = ("count", "mean", "m2", "amax", "vmin", "vmax")


def stats_arrays(prefix: str, s: DimStats) -> dict:
    """DimStats -> npz-fragment dict keyed ``{prefix}{field}`` (numpy)."""
    return {f"{prefix}{f}": getattr(s, f).detach().cpu().numpy()
            for f in STATS_FIELDS}


def stats_from_arrays(prefix: str, arrays, device=None) -> DimStats:
    """Inverse of :func:`stats_arrays`."""
    import numpy as np

    return DimStats(**{
        f: torch.from_numpy(np.array(arrays[f"{prefix}{f}"],
                                     dtype=np.float32)).to(device)
        for f in STATS_FIELDS})


class StreamingStats:
    """Accumulate :class:`DimStats` over a stream of [n_i, d] batches
    (one pass, O(d) state): ``update`` merges a batch's ``corpus_stats``,
    ``merge`` folds in another collector or a raw ``DimStats``."""

    def __init__(self, d: int, dtype=torch.float32, device=None):
        self._s = empty_stats(d, dtype, device)

    def update(self, batch: torch.Tensor) -> "StreamingStats":
        batch = batch.to(self._s.mean.device)
        self._s = merge_stats(self._s, corpus_stats(batch))
        return self

    def merge(self, other: "StreamingStats | DimStats") -> "StreamingStats":
        """Fold another collector (or raw ``DimStats``) into this one; an
        empty one is the identity."""
        s = other.stats if isinstance(other, StreamingStats) else other
        dev = self._s.mean.device
        s = DimStats(**{f: getattr(s, f).to(dev) for f in STATS_FIELDS})
        self._s = merge_stats(self._s, s)
        return self

    @property
    def stats(self) -> DimStats:
        return self._s

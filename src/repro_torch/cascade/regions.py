"""Density-aware per-region Eq. 1 constants (port of
``repro.cascade.regions``).

One Eq. 1 constant set per *region* (an IVF list, an HNSW k-means cell
or a graph seed's neighbourhood) instead of one per corpus, with the
clamp width of region r scaled by its population:

    sigmas_r = base_sigmas * clip((mean_count / count_r) ** 0.25, 0.5, 2.0)

Dense regions get a narrower clamp (a finer LSB), sparse ones a wider
one.  Only the Gaussian-family schemes read sigmas.  Codes under
different regions' constants live in different integer spaces, so
regional scoring dequantizes each gathered row
(``engine.topk_among_regional``).

Where the numbers are made: ``fit`` reduces every region's statistics
on the host CPU whatever the index's device, so a card build and a CPU
build of one corpus hold the same constants, and then ``encode`` (plain
elementwise torch, in the reference's order: subtract, times 2^B, IEEE
divide, round half to even, clip) gives the same codes on both.  The
density scales and sigmas are the reference's numpy expressions.  The
statistics themselves are float sums in torch's order, not XLA's, so
they agree with the reference's to about 1e-6 relative, as
``core.stats.corpus_stats`` does; the private ``_stats`` argument of
``fit`` takes the reference's (or another build's) per-region statistics,
and then the constants are the reference's bit for bit.

Persistence: the npz fragments of the reference, under a caller-chosen
prefix: ``{prefix}assign``, ``lo``, ``hi``, ``zero``, ``sigmas``, the
stacked statistics as ``{prefix}st_*`` and the meta record
``{prefix}regions``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import quant as Qz
from repro_torch.core import stats as St
from repro_torch.device import to_tensor

#: density-scale bounds: sigmas_r / base_sigmas stays inside these
DENSITY_SCALE_RANGE = (0.5, 2.0)
DENSITY_SCALE_POWER = 0.25


def density_scales(counts: np.ndarray) -> np.ndarray:
    """Per-region clamp-width multipliers from region populations ([R]
    float32, the reference's numpy expression)."""
    counts = np.asarray(counts, np.float64)
    occupied = counts[counts > 0]
    mean_count = float(occupied.mean()) if occupied.size else 1.0
    lo, hi = DENSITY_SCALE_RANGE
    scales = (mean_count / np.maximum(counts, 1.0)) ** DENSITY_SCALE_POWER
    return np.clip(scales, lo, hi).astype(np.float32)


def _stack(per: list[St.DimStats]) -> St.DimStats:
    return St.DimStats(**{f: torch.stack([getattr(s, f) for s in per])
                          for f in St.STATS_FIELDS})


@dataclasses.dataclass(frozen=True)
class RegionQuant:
    """Per-region Eq. 1 constants and the row -> region assignment.

    assign [N] int32; lo / hi / zero [R, d] f32 constant stacks; sigmas
    [R] the density-scaled clamp widths used; stats the stacked
    per-region calibration ``DimStats`` (count [R], moments [R, d]), kept
    for drift reports.  Every tensor lives on one device."""

    assign: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    zero: torch.Tensor
    sigmas: torch.Tensor
    stats: St.DimStats
    bits: int
    scheme: str

    # -- accounting --------------------------------------------------------
    @property
    def n_regions(self) -> int:
        return int(self.lo.shape[0])

    @property
    def device(self) -> torch.device:
        return self.lo.device

    @property
    def scale(self) -> torch.Tensor:
        """[R, d] LSB sizes: what the regional scorer gathers per row."""
        return (self.hi - self.lo) / (2.0 ** self.bits)

    def memory_bytes(self) -> int:
        return (int(self.assign.numel()) * self.assign.element_size()
                + 3 * int(self.lo.numel()) * 4)

    def to(self, device) -> "RegionQuant":
        return dataclasses.replace(
            self, assign=self.assign.to(device), lo=self.lo.to(device),
            hi=self.hi.to(device), zero=self.zero.to(device),
            sigmas=self.sigmas.to(device),
            stats=St.DimStats(**{f: getattr(self.stats, f).to(device)
                                 for f in St.STATS_FIELDS}))

    # -- fit / encode ------------------------------------------------------
    @staticmethod
    def fit(corpus, assign, n_regions: int, *, bits: int = 8,
            scheme: str = "gaussian", sigmas: float = 1.0, device=None,
            _stats: Optional[St.DimStats] = None) -> "RegionQuant":
        """Fit one Eq. 1 constant set per region, density-scaled, on the
        host CPU; the result lives on ``device`` (default: the corpus's).

        ``assign`` [N] maps each corpus row to its region.  An empty region
        gets the empty-statistics constants (never read: no row is
        assigned to it).  ``_stats`` (stacked per-region ``DimStats``)
        replaces the reduction of the rows."""
        if device is None:
            device = corpus.device if isinstance(corpus, torch.Tensor) else "cpu"
        if isinstance(corpus, torch.Tensor):
            corpus = corpus.detach().cpu().numpy()
        corpus = np.asarray(corpus, np.float32)
        assign = np.asarray(assign.cpu() if isinstance(assign, torch.Tensor)
                            else assign, np.int32)
        counts = np.bincount(assign, minlength=n_regions)[:n_regions]
        scales = density_scales(counts)
        if _stats is None:
            # rows by region, ascending ids within each, as corpus[assign == r]
            order = np.argsort(assign, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)])
            x = torch.from_numpy(corpus[order])
            per_stats = [St.corpus_stats(x[starts[r]:starts[r + 1]])
                         for r in range(n_regions)]
        else:
            per_stats = [St.DimStats(**{f: getattr(_stats, f)[r].cpu()
                                        for f in St.STATS_FIELDS})
                         for r in range(n_regions)]
        per_params = [
            Qz.params_from_stats(s, bits=bits, scheme=scheme,
                                 sigmas=float(sigmas * scales[r]))
            for r, s in enumerate(per_stats)
        ]
        return RegionQuant(
            assign=torch.from_numpy(assign),
            lo=torch.stack([p.lo for p in per_params]),
            hi=torch.stack([p.hi for p in per_params]),
            zero=torch.stack([p.zero for p in per_params]),
            sigmas=torch.from_numpy(np.asarray(sigmas * scales, np.float32)),
            stats=_stack(per_stats),
            bits=int(bits),
            scheme=str(Qz.Scheme(scheme).value),
        ).to(device)

    def region_params(self, r: int) -> Qz.QuantParams:
        """The r-th region's constants as an ordinary ``QuantParams``."""
        return Qz.QuantParams(lo=self.lo[r], hi=self.hi[r], zero=self.zero[r],
                              bits=self.bits, scheme=self.scheme)

    def encode(self, corpus) -> torch.Tensor:
        """Eq. 1 per row under the row's own region's constants ([N, d]
        int8, on this object's device)."""
        x = to_tensor(corpus, device=self.device, dtype=torch.float32)
        a = self.assign.long()
        lo, hi, zero = self.lo[a], self.hi[a], self.zero[a]
        span = torch.clamp_min(hi - lo, 1e-12)
        q = torch.round((2.0 ** self.bits) * (x - zero) / span)
        qmin, qmax = -(2 ** (self.bits - 1)), 2 ** (self.bits - 1) - 1
        return torch.clamp(q, qmin, qmax).to(torch.int8)

    def dequant(self, codes: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Midpoint reconstruction of ``codes`` gathered at row ids
        ``rows``, each row through its own region's inverse map."""
        reg = self.assign[rows.long()].long()
        return codes.to(torch.float32) * self.scale[reg] + self.zero[reg]

    # -- drift -------------------------------------------------------------
    def region_stats(self, r: int) -> St.DimStats:
        """The r-th region's calibration statistics."""
        return St.DimStats(**{f: getattr(self.stats, f)[r]
                              for f in St.STATS_FIELDS})

    def drift_report(self, live_corpus, live_assign) -> np.ndarray:
        """Per-region calibration drift of a live corpus against the fitted
        constants: [R] float64 of ``stats.calibration_drift`` (+inf where
        either side is empty), reduced on the host CPU."""
        if isinstance(live_corpus, torch.Tensor):
            live_corpus = live_corpus.detach().cpu().numpy()
        if isinstance(live_assign, torch.Tensor):
            live_assign = live_assign.cpu().numpy()
        live_corpus = np.asarray(live_corpus, np.float32)
        live_assign = np.asarray(live_assign, np.int32)
        out = np.zeros(self.n_regions, np.float64)
        for r in range(self.n_regions):
            live = St.corpus_stats(torch.from_numpy(
                live_corpus[live_assign == r]))
            calib = St.DimStats(**{f: v.cpu() for f, v in
                                   vars(self.region_stats(r)).items()})
            out[r] = St.calibration_drift(calib, live)
        return out

    # -- disk round-trip fragments ----------------------------------------
    def state(self, prefix: str = "rg_") -> tuple[dict[str, Any],
                                                  dict[str, Any]]:
        """(arrays, meta) npz fragments, ``CodeStore.state``-style."""
        arrays = {
            f"{prefix}assign": self.assign.cpu().numpy(),
            f"{prefix}lo": self.lo.cpu().numpy(),
            f"{prefix}hi": self.hi.cpu().numpy(),
            f"{prefix}zero": self.zero.cpu().numpy(),
            f"{prefix}sigmas": self.sigmas.cpu().numpy(),
        }
        arrays.update(St.stats_arrays(f"{prefix}st_", self.stats))
        meta = {f"{prefix}regions": {"n_regions": self.n_regions,
                                     "bits": self.bits,
                                     "scheme": self.scheme}}
        return arrays, meta

    @staticmethod
    def from_state(arrays, meta, prefix: str = "rg_",
                   device=None) -> "RegionQuant":
        rm = meta[f"{prefix}regions"]

        def t(name, dtype):
            return to_tensor(np.asarray(arrays[f"{prefix}{name}"]),
                             device=device, dtype=dtype).contiguous()

        return RegionQuant(
            assign=t("assign", torch.int32), lo=t("lo", torch.float32),
            hi=t("hi", torch.float32), zero=t("zero", torch.float32),
            sigmas=t("sigmas", torch.float32),
            stats=St.stats_from_arrays(f"{prefix}st_", arrays, device=device),
            bits=int(rm["bits"]), scheme=str(rm["scheme"]),
        )

"""The paper's quantization family (Q, phi), §3 — port of ``repro.core.quant``.

Eq. 1 (clamped linear quantization of dimension i at bit-width B):

    Q(x^i) = round( 2^B * (x^i - k^i) / (S_e^i - S_b^i) )

clipped to the storable range [-2^(B-1), 2^(B-1)-1] (DESIGN.md §2: the
single saturated code at the top is part of the clamp semantics).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from repro_torch.core.stats import DimStats, corpus_stats


class Scheme(str, enum.Enum):
    """Which normalizing constants to use for Eq. 1 (see the reference for
    the geometry note: GLOBAL_* schemes are one affine map for all dims)."""

    GAUSSIAN = "gaussian"            # §3.2: per-dim mu +- sigmas*sigma
    UNIFORM_GAUSSIAN = "uniform"     # §4.1: single (mu, sigma) for all dims
    ABSMAX = "absmax"                # §4.2: per-dim [-amax, +amax], k = 0
    MINMAX = "minmax"                # engineering variant: [vmin, vmax]
    GLOBAL_ABSMAX = "global_absmax"  # one symmetric span for all dims
    GLOBAL_MINMAX = "global_minmax"  # one [min, max] span for all dims


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Normalizing constants of Eq. 1 for one corpus: lo = S_b, hi = S_e,
    zero = k, each [d] f32; ``bits`` is B."""

    lo: torch.Tensor
    hi: torch.Tensor
    zero: torch.Tensor
    bits: int
    scheme: str

    @property
    def scale(self) -> torch.Tensor:
        return (self.hi - self.lo) / (2.0 ** self.bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.int8
        if self.bits <= 16:
            return torch.int16
        return torch.int32

    def to(self, device) -> "QuantParams":
        return dataclasses.replace(
            self, lo=self.lo.to(device), hi=self.hi.to(device),
            zero=self.zero.to(device))


def params_from_stats(
    stats: DimStats,
    bits: int = 8,
    scheme: Scheme | str = Scheme.GAUSSIAN,
    sigmas: float = 1.0,
) -> QuantParams:
    """Turn per-dimension corpus stats into Eq. 1 constants."""
    scheme = Scheme(scheme)
    if scheme == Scheme.UNIFORM_GAUSSIAN:
        stats = stats.uniform()

    if scheme in (Scheme.GAUSSIAN, Scheme.UNIFORM_GAUSSIAN):
        mu, sd = stats.mean, stats.std * sigmas
        sd = torch.clamp_min(sd, 1e-12)
        lo, hi, zero = mu - sd, mu + sd, mu
    elif scheme == Scheme.ABSMAX:
        amax = torch.clamp_min(stats.amax, 1e-12)
        lo, hi = -amax, amax
        zero = torch.zeros_like(amax)
    elif scheme == Scheme.MINMAX:
        lo, hi = stats.vmin, stats.vmax
        hi = torch.where(hi - lo < 1e-12, lo + 1e-12, hi)
        zero = (lo + hi) / 2.0
    elif scheme == Scheme.GLOBAL_ABSMAX:
        amax = torch.clamp_min(torch.max(stats.amax), 1e-12)
        full = torch.ones_like(stats.amax)
        lo, hi = -amax * full, amax * full
        zero = torch.zeros_like(full)
    elif scheme == Scheme.GLOBAL_MINMAX:
        gmin, gmax = torch.min(stats.vmin), torch.max(stats.vmax)
        gmax = torch.where(gmax - gmin < 1e-12, gmin + 1e-12, gmax)
        full = torch.ones_like(stats.amax)
        lo, hi = gmin * full, gmax * full
        zero = (gmin + gmax) / 2.0 * full
    else:  # pragma: no cover
        raise ValueError(f"unknown scheme {scheme}")
    return QuantParams(lo=lo, hi=hi, zero=zero, bits=bits, scheme=scheme.value)


def learn_params(
    corpus: torch.Tensor,
    bits: int = 8,
    scheme: Scheme | str = Scheme.GAUSSIAN,
    sigmas: float = 1.0,
    stats: Optional[DimStats] = None,
) -> QuantParams:
    """Fit Eq. 1 constants on a corpus ([N, d]) — the paper's MLE step."""
    if stats is None:
        stats = corpus_stats(corpus)
    return params_from_stats(stats, bits=bits, scheme=scheme, sigmas=sigmas)


def quantize(x: torch.Tensor, params: QuantParams) -> torch.Tensor:
    """Eq. 1 elementwise over the trailing dim of ``x``, in the reference's
    op order (subtract, times 2^B, IEEE divide, round half to even, clip)."""
    span = torch.clamp_min(params.hi - params.lo, 1e-12)
    q = torch.round((2.0 ** params.bits) * (x.to(torch.float32) - params.zero)
                    / span)
    q = torch.clamp(q, params.qmin, params.qmax)
    return q.to(params.storage_dtype)


def dequantize(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    """Inverse linear map (midpoint reconstruction), diagnostics only."""
    return q.to(torch.float32) * params.scale + params.zero


def quantization_error(x: torch.Tensor, params: QuantParams) -> torch.Tensor:
    """Mean-squared reconstruction error (not the paper's objective: order
    preservation, not MSE, is what drives recall)."""
    return torch.mean((dequantize(quantize(x, params), params)
                       - x.to(torch.float32)) ** 2)


# --------------------------------------------------------------------------
# Convenience one-call API used by the graph utilities.
# --------------------------------------------------------------------------

def quantize_corpus(
    corpus: torch.Tensor,
    bits: int = 8,
    scheme: Scheme | str = Scheme.GAUSSIAN,
    sigmas: float = 1.0,
):
    """learn + apply: returns (codes, params)."""
    params = learn_params(corpus, bits=bits, scheme=scheme, sigmas=sigmas)
    return quantize(corpus, params), params

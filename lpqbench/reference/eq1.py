"""Eq. 1 of the paper, in plain PyTorch, written from its definition:

    Q(x^i) = round( 2^B (x^i - k^i) / (S_e^i - S_b^i) ),  clipped to
             [-2^(B-1), 2^(B-1) - 1]

with the normalizing constants of each scheme: ``gaussian`` (per
dimension mu -+ sigmas * sigma, k = mu), ``global_minmax`` (one [min,
max] span for every dimension, k its midpoint).  Constants are computed in
float64 from the corpus; codes in float32, in the order the definition
writes it (subtract, times 2^B, divide, round half to even, clip), which
is the order any float32 implementation of it has to keep to give the
same codes.
"""

from __future__ import annotations

import torch

SCHEMES = ("gaussian", "global_minmax")


def constants(slabs, d: int, scheme: str, sigmas: float, dev,
              dtype=torch.float64):
    """(lo, hi, zero), each [d] of ``dtype``, of the corpus given as an
    iterable of [r, d] slabs (walked twice for ``gaussian``)."""
    if scheme not in SCHEMES:
        raise ValueError(f"reference: unknown Eq. 1 scheme {scheme!r}")
    slabs = list(slabs)
    if scheme == "global_minmax":
        lo = min(torch.amin(x).to(dtype) for x in slabs)
        hi = max(torch.amax(x).to(dtype) for x in slabs)
        full = torch.ones(d, dtype=dtype, device=dev)
        return lo * full, hi * full, (lo + hi) / 2 * full
    n = sum(x.shape[0] for x in slabs)
    mean = sum(torch.sum(x.to(dtype), dim=0) for x in slabs) / n
    m2 = sum(torch.sum((x.to(dtype) - mean) ** 2, dim=0) for x in slabs)
    sd = torch.clamp_min(torch.sqrt(m2 / n) * sigmas, 1e-12)
    return mean - sd, mean + sd, mean


def value(x: torch.Tensor, lo, hi, zero, bits: int,
          dtype=torch.float32) -> torch.Tensor:
    """[r, d] rows -> Eq. 1's value before rounding, computed in ``dtype``."""
    lo, hi, zero = (c.to(device=x.device, dtype=dtype) for c in (lo, hi, zero))
    span = torch.clamp_min(hi - lo, 1e-12)
    return (2.0 ** bits) * (x.to(dtype) - zero) / span


def to_code(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Eq. 1's values -> int8 codes: round half to even, then clip."""
    return torch.clamp(torch.round(v), -(2 ** (bits - 1)),
                       2 ** (bits - 1) - 1).to(torch.int8)


def encode(x: torch.Tensor, lo, hi, zero, bits: int,
           dtype=torch.float32) -> torch.Tensor:
    """[r, d] rows -> int8 codes of Eq. 1, computed in ``dtype``."""
    return to_code(value(x, lo, hi, zero, bits, dtype), bits)

"""Per-dimension corpus statistics for data-driven quantization (paper §3.2);
port of ``repro.core.stats`` (one-shot collector; the streaming and
distributed collectors come with the stream and dist slices).
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

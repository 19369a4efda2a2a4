"""Per-dimension Gaussian embeddings (frozen copy of the form of
``repro_torch.data.synthetic.glove_like``): zero mean, each dimension's
scale drawn once per dataset from [``scale_lo``, ``scale_hi``)."""

from __future__ import annotations

import torch


def sampler(params: dict, d: int, g: torch.Generator, dev):
    lo, hi = float(params["scale_lo"]), float(params["scale_hi"])
    dim_scale = lo + torch.rand(d, generator=g, device=dev) * (hi - lo)

    def draw(g: torch.Generator, rows: int) -> torch.Tensor:
        return torch.randn(rows, d, generator=g, device=dev) * dim_scale[None, :]

    return draw

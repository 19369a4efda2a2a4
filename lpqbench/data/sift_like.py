"""SIFT-like descriptors (frozen copy of the form of
``repro_torch.data.synthetic.sift_like``): non-negative Gamma(2, 1)
magnitudes times ``scale`` on an integer grid in [0, ``max``].  BIGANN's
vectors are SIFT descriptors, uint8 in [0, 255]; this draws integers in
[0, 218] stored as float32."""

from __future__ import annotations

import torch


def sampler(params: dict, d: int, g: torch.Generator, dev):
    del g                                   # no per-dataset draws
    scale, top = float(params["scale"]), float(params["max"])

    def draw(g: torch.Generator, rows: int) -> torch.Tensor:
        # Gamma(2, 1) is the sum of two unit exponentials
        mag = torch.empty(rows, d, device=dev).exponential_(generator=g)
        mag += torch.empty(rows, d, device=dev).exponential_(generator=g)
        return torch.floor(torch.clamp(mag * scale, 0.0, top))

    return draw

"""Synthetic dataset generators matching the paper's evaluation corpora
(port of ``repro.data.synthetic``).

Same distributions as the reference, drawn from a ``torch.Generator`` on
the target device (default: the GPU), so the numbers differ from the
reference's ``jax.random`` draws:

  * ``product_embeddings`` — PRODUCT60M-like narrow band (paper Fig 1): a
    heavy-centre Gaussian mixture, 50% in the +-(.08, .125) band tails,
    clipped to (-.125, .125), the same for every dimension (ip metric).
  * ``sift_like`` — SIFT-like: non-negative Gamma(2)·18 magnitudes on an
    integer grid in [0, 218] (l2 metric).
  * ``glove_like`` — GloVe-like: per-dim Gaussian with per-dim scales in
    [0.3, 0.8) (angular metric).

All return (corpus [N, d] f32, queries [Q, d] f32), drawn in row slabs so a
multi-million-row corpus never needs more than one slab of temporaries.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

_SLAB = 1 << 20


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _slabs(rows: int, d: int, dev, draw) -> torch.Tensor:
    out = torch.empty((rows, d), dtype=torch.float32, device=dev)
    for s in range(0, rows, _SLAB):
        out[s:s + _SLAB] = draw(min(_SLAB, rows - s))
    return out


def product_embeddings(n: int, d: int = 256, n_queries: int = 1000,
                       seed: int = 0, device=None):
    """Narrow-band e-commerce-style embeddings (paper Fig 1)."""
    dev = resolve_device(device)
    g = _generator(seed, dev)

    def draw(rows):
        centre = torch.randn(rows, d, generator=g, device=dev) * 0.04
        band = torch.sign(torch.randn(rows, d, generator=g, device=dev))
        band *= 0.08 + 0.045 * torch.rand(rows, d, generator=g, device=dev)
        pick = torch.rand(rows, d, generator=g, device=dev) < 0.5
        return torch.where(pick, band, centre).clamp_(-0.12499, 0.12499)

    return _slabs(n, d, dev, draw), _slabs(n_queries, d, dev, draw)


def sift_like(n: int, d: int = 128, n_queries: int = 1000, seed: int = 1,
              device=None):
    """SIFT-style descriptors: non-negative, gamma-ish, L2 metric."""
    dev = resolve_device(device)
    g = _generator(seed, dev)

    def draw(rows):
        # Gamma(2, 1) is the sum of two unit exponentials
        mag = torch.empty(rows, d, device=dev).exponential_(generator=g)
        mag += torch.empty(rows, d, device=dev).exponential_(generator=g)
        return torch.floor(torch.clamp(mag * 18.0, 0.0, 218.0))

    return _slabs(n, d, dev, draw), _slabs(n_queries, d, dev, draw)


def glove_like(n: int, d: int = 100, n_queries: int = 1000, seed: int = 2,
               device=None):
    """GloVe-style word embeddings: per-dim Gaussian, angular metric."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    dim_scale = 0.3 + torch.rand(d, generator=g, device=dev) * 0.5

    def draw(rows):
        return torch.randn(rows, d, generator=g, device=dev) * dim_scale[None, :]

    return _slabs(n, d, dev, draw), _slabs(n_queries, d, dev, draw)


DATASETS = {
    "product": product_embeddings,
    "sift": sift_like,
    "glove": glove_like,
}

METRIC_FOR = {"product": "ip", "sift": "l2", "glove": "angular"}


def load(name: str, n: int, n_queries: int = 1000, seed: int | None = None,
         device=None):
    """(corpus, queries, metric) for a named paper dataset family."""
    kw = {} if seed is None else {"seed": seed}
    corpus, queries = DATASETS[name](n, n_queries=n_queries, device=device,
                                     **kw)
    return corpus, queries, METRIC_FOR[name]

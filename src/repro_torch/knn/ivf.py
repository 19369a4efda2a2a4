"""k-means, the coarse quantizer (port of ``repro.knn.ivf.kmeans``).

Only ``kmeans`` is ported so far: PQ trains its per-subspace codebooks
with it.  The ``ivf`` index kind itself is not ported yet (ROADMAP queue
A7); the registry raises for it.
"""

from __future__ import annotations

import torch

from repro_torch.core import distances as D

#: score-matrix entries one assignment chunk may hold ([rows, C] f32, 256 MB)
_ASSIGN_ENTRIES = 1 << 26


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by L2 for every row of ``x`` ([N] int64), the
    first one on ties; [rows, C] score chunks bound the working set."""
    rows = max(1, _ASSIGN_ENTRIES // cents.shape[0])
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], rows):
        out[s:s + rows] = torch.argmax(D.l2_scores(x[s:s + rows], cents), dim=-1)
    return out


def kmeans(x: torch.Tensor, n_clusters: int, key: int = 0,
           iters: int = 10) -> torch.Tensor:
    """Plain Lloyd k-means, random init, [N, d] -> [n_clusters, d].

    ``key`` seeds a ``torch.Generator`` on ``x``'s device, which draws the
    initial centroids (distinct rows).  Each step assigns every row to its
    nearest centroid (first index on ties) and moves each centroid to its
    rows' mean; an empty cluster keeps its old centroid.  The reference
    draws its init from ``jax.random``, so the two give different
    codebooks from the same seed; only their quality is comparable.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    g = torch.Generator(device=x.device)
    g.manual_seed(int(key))
    cents = x[torch.randperm(n, generator=g, device=x.device)[:n_clusters]]
    rows = max(1, _ASSIGN_ENTRIES // n_clusters)
    for _ in range(iters):
        a = _assign(x, cents)
        counts = torch.bincount(a, minlength=n_clusters).to(torch.float32)
        sums = torch.zeros_like(cents)
        for s in range(0, n, rows):                 # one-hot^T @ x, chunked
            one_hot = torch.nn.functional.one_hot(
                a[s:s + rows], n_clusters).to(torch.float32)
            sums += one_hot.T @ x[s:s + rows]
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents

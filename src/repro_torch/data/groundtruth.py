"""Exact ground-truth computation for recall measurement (paper §5.3; port
of ``repro.data.groundtruth``)."""

from __future__ import annotations

from repro_torch.knn.flat import FlatIndex


def exact_topk(corpus, queries, k: int, metric: str, device=None):
    """fp32 exhaustive top-k — S_E of the paper's recall definition (B2
    fp32 on the card; ``device`` as ``FlatIndex.build``'s)."""
    return FlatIndex.build(corpus, metric=metric, device=device).search(
        queries, k)

"""Workload data (port of ``repro.data``): the synthetic paper corpora,
criteo-style CTR batches (``recsys_data``) and exact ground truth for
recall (``exact_topk``)."""

from repro_torch.data import recsys_data, synthetic
from repro_torch.data.groundtruth import exact_topk

__all__ = ["recsys_data", "synthetic", "exact_topk"]

"""Workload data (port of ``repro.data``): the synthetic paper corpora,
criteo-style CTR batches (``recsys_data``), synthetic LM token batches
(``lm_data``) and exact ground truth for recall (``exact_topk``)."""

from repro_torch.data import lm_data, recsys_data, synthetic
from repro_torch.data.groundtruth import exact_topk

__all__ = ["lm_data", "recsys_data", "synthetic", "exact_topk"]

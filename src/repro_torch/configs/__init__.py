"""Architecture configurations (port of ``repro.configs``): ``base``, the
five LM architectures (``gemma_2b``, ``gemma2_9b``, ``minicpm_2b``,
``llama4_scout``, ``llama4_maverick``), the four recsys architectures
(``autoint``, ``dcn_v2``, ``dien``, ``dlrm_mlperf``), the paper's own
``lpq_ann``, the GNN ``schnet`` and the ``registry`` over them.  Copied, not imported: the
port imports nothing of the reference package."""

from repro_torch.configs.registry import ARCHS, ASSIGNED, cells, get

__all__ = ["ARCHS", "ASSIGNED", "cells", "get"]

"""Model zoo (port of ``repro.models``): the shared layers, the LM family
(``attention``, ``flash``, ``moe``, ``transformer``), the recsys family
(``models.recsys``: embeddings, interactions, the four CTR architectures,
candidate retrieval) and the GNN family (``models.gnn``: SchNet)."""

from repro_torch.models import attention, flash, layers, moe, transformer
from repro_torch.models.recsys.models import RecsysConfig
from repro_torch.models.transformer import LMConfig

__all__ = ["attention", "flash", "layers", "moe", "transformer", "LMConfig",
           "RecsysConfig"]

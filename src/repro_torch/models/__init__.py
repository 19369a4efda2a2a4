"""Model zoo (port of ``repro.models``): the shared layers and the recsys
family (``models.recsys``: embeddings, interactions, the four CTR
architectures, candidate retrieval).  The LM and GNN families come in
later slices."""

from repro_torch.models import layers
from repro_torch.models.recsys.models import RecsysConfig

__all__ = ["layers", "RecsysConfig"]

"""The recsys family (port of ``repro.models.recsys``): the embedding
substrate with the paper's int8 ``QuantizedTable``, candidate retrieval
and ``RecsysConfig``.  The interaction layers, ``init_params`` and the
per-kind forwards come with training (ROADMAP A16)."""

from repro_torch.models.recsys import embedding, models, retrieval
from repro_torch.models.recsys.models import RecsysConfig

__all__ = ["embedding", "models", "retrieval", "RecsysConfig"]

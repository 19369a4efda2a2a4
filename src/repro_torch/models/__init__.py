"""Model zoo (port of ``repro.models``): so far the recsys family's
embedding substrate and candidate retrieval (``models.recsys``)."""

from repro_torch.models.recsys.models import RecsysConfig

__all__ = ["RecsysConfig"]

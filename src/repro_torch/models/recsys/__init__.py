"""The recsys family (port of ``repro.models.recsys``): the embedding
substrate with the paper's int8 ``QuantizedTable``, the feature
interactions, the four architectures' ``init_params`` / ``forward`` /
``serve`` / ``bce_loss``, candidate retrieval and ``RecsysConfig``.
``launch.steps.make_recsys_train_step`` trains on ``bce_loss``'s
gradient."""

from repro_torch.models.recsys import embedding, interactions, models, retrieval
from repro_torch.models.recsys.models import RecsysConfig

__all__ = ["embedding", "interactions", "models", "retrieval", "RecsysConfig"]

"""dien [arXiv:1809.03672; unverified]: embed_dim 18, behaviour sequence
length 100, GRU + AUGRU interest evolution with gru_dim 108, final MLP
200-80, AUGRU interaction.  Field 0 is the item table (also used for the
behaviour history); amazon-books-scale vocabularies.
Port of ``repro.configs.dien``."""

from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "dien"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        kind="dien",
        n_dense=0,
        vocab_sizes=(63_001, 801, 192_403),   # item, category, user
        embed_dim=18,
        seq_len=100,
        gru_dim=108,
        mlp=(200, 80),
    )


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke",
        kind="dien",
        n_dense=0,
        vocab_sizes=(500, 50, 300),
        embed_dim=8,
        seq_len=12,
        gru_dim=16,
        mlp=(24, 12),
    )

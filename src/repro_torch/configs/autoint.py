"""autoint [arXiv:1810.11921]: 39 sparse fields (criteo: 13 bucketized
dense + 26 categorical), embed_dim 16, 3 interacting self-attention
layers with 2 heads of d_attn 32.
Port of ``repro.configs.autoint``."""

from repro_torch.configs.base import CRITEO_DENSE_BUCKETS, CRITEO_VOCABS, RECSYS_SHAPES
from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "autoint"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        kind="autoint",
        n_dense=0,
        vocab_sizes=CRITEO_DENSE_BUCKETS + CRITEO_VOCABS,   # 39 fields
        embed_dim=16,
        n_attn_layers=3,
        n_heads=2,
        d_attn=32,
    )


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke",
        kind="autoint",
        n_dense=0,
        vocab_sizes=(64,) * 6 + (500, 300),
        embed_dim=8,
        n_attn_layers=2,
        n_heads=2,
        d_attn=8,
    )

"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse (embed_dim 16, Criteo
hash sizes), 3 full-rank cross layers, deep tower 1024-1024-512.
Port of ``repro.configs.dcn_v2``."""

from repro_torch.configs.base import CRITEO_VOCABS, RECSYS_SHAPES
from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "dcn-v2"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        kind="dcnv2",
        n_dense=13,
        vocab_sizes=CRITEO_VOCABS,
        embed_dim=16,
        n_cross_layers=3,
        mlp=(1024, 1024, 512),
    )


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke",
        kind="dcnv2",
        n_dense=13,
        vocab_sizes=(500, 100, 50, 2000),
        embed_dim=8,
        n_cross_layers=2,
        mlp=(32, 16),
    )

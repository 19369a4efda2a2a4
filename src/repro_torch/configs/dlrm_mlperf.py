"""dlrm-mlperf [arXiv:1906.00091]: the MLPerf DLRM benchmark config
(Criteo 1TB) — 13 dense features through bottom MLP 512-256-128, 26
categorical features with embed_dim 128 over the Criteo hash sizes
(~187M rows total), dot interaction, top MLP 1024-1024-512-256-1.
Port of ``repro.configs.dlrm_mlperf``."""

from repro_torch.configs.base import CRITEO_VOCABS, RECSYS_SHAPES
from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SKIP = {}


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        kind="dlrm",
        n_dense=13,
        vocab_sizes=CRITEO_VOCABS,
        embed_dim=128,
        bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
    )


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke",
        kind="dlrm",
        n_dense=13,
        vocab_sizes=(500, 100, 50, 2000),
        embed_dim=16,
        bot_mlp=(32, 16),
        top_mlp=(32, 16, 1),
    )

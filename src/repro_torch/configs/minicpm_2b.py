"""minicpm-2b [arXiv:2404.06395]: 40L, d_model 2304, 36 heads MHA
(kv=36), head_dim 64, d_ff 5760 (SwiGLU, llama-like), vocab 122753.
Trains with the WSD schedule (the reference's ``train.optimizer``,
schedule="wsd").
Port of ``repro.configs.minicpm_2b``."""

from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "minicpm-2b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_MICROBATCHES = 8
SKIP = {
    "long_500k": "pure global full attention; no sub-quadratic path "
    "(DESIGN.md §6)",
}

OPTIMIZER_SCHEDULE = "wsd"           # the arch's signature training recipe


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv=36,                     # full MHA
        head_dim=64,
        d_ff=5760,
        vocab=122_753,
        act="silu",                  # llama-like SwiGLU
        layer_pattern="g",
        scale_embed=True,            # minicpm scales embeddings (mu-param)
        dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=72,
        n_heads=6,
        n_kv=6,
        head_dim=12,
        d_ff=144,
        vocab=512,
        act="silu",
        layer_pattern="g",
        dtype="float32",
        block_kv=16,
        remat=False,
    )

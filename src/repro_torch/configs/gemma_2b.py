"""gemma-2b [arXiv:2403.08295]: 18L, d_model 2048, 8 heads with MQA
(kv=1), head_dim 256, d_ff 16384 (GeGLU), vocab 256000.
Port of ``repro.configs.gemma_2b``."""

from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma-2b"
FAMILY = "lm"
SHAPES = LM_SHAPES
SKIP = {
    "long_500k": "pure global full attention; no sub-quadratic path "
    "(DESIGN.md §6)",
}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv=1,                      # MQA on 2b
        head_dim=256,
        d_ff=16384,
        vocab=256_000,
        act="gelu",                  # GeGLU
        layer_pattern="g",
        scale_embed=True,
        dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        act="gelu",
        layer_pattern="g",
        dtype="float32",
        block_kv=16,
        remat=False,
    )

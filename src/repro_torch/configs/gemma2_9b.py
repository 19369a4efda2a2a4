"""gemma2-9b [arXiv:2408.00118]: 42L, d_model 3584, 16 heads GQA kv=8,
head_dim 256, d_ff 14336, vocab 256000 — alternating local(4096)/global
attention with attention (50.0) and final (30.0) logit soft-caps.
Port of ``repro.configs.gemma2_9b``."""

from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma2-9b"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_MICROBATCHES = 8
SKIP = {}  # local+global alternating -> long_500k runs (DESIGN.md §6)


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv=8,
        head_dim=256,
        d_ff=14336,
        vocab=256_000,
        act="gelu",
        layer_pattern="lg",          # local, global, local, global, ...
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        scale_embed=True,
        dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        act="gelu",
        layer_pattern="lg",
        window=8,
        attn_softcap=50.0,
        final_softcap=30.0,
        dtype="float32",
        block_kv=16,
        remat=False,
    )

"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L, d_model 5120, 40 heads GQA kv=8, head_dim 128, vocab 202048, MoE 16
experts top-1 routed + shared expert (d_ff 8192 per expert), iRoPE-style
chunked-local attention on 3 of every 4 layers (chunk 8192) — which is
what makes the long_500k cell sub-quadratic for this arch.
Port of ``repro.configs.llama4_scout``."""

from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "llama4-scout-17b-16e"
FAMILY = "lm"
SHAPES = LM_SHAPES
TRAIN_MICROBATCHES = 16
SKIP = {}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv=8,
        head_dim=128,
        d_ff=8192,
        vocab=202_048,
        act="silu",
        layer_pattern="cccg",        # chunked x3, global x1 (iRoPE)
        chunk=8192,
        scale_embed=False,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, shared_expert=True),
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
        act="silu",
        layer_pattern="cccg",
        chunk=8,
        scale_embed=False,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=128, shared_expert=True),
        dtype="float32",
        block_kv=16,
        remat=False,
    )

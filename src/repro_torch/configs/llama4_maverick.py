"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Maverick; unverified]:
same trunk as scout (48L, d_model 5120, 40H GQA kv=8, vocab 202048) with
MoE 128 experts top-1 + shared expert — ~400B total, ~17B active.

The "400b" total is only consistent with the hf config's
interleave_moe_layer_step=2: MoE on every second layer (24 MoE + 24 dense
layers, dense FFN d_ff 16384).  All-48-MoE would be ~780B.  We model the
interleave with moe_every=2 (DESIGN.md §Arch notes).
Port of ``repro.configs.llama4_maverick``."""

from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "llama4-maverick-400b-17b"
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
        layer_pattern="cccg",
        chunk=8192,
        scale_embed=False,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, shared_expert=True),
        moe_every=2,
        dense_d_ff=16384,
        dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
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
        moe=MoEConfig(n_experts=8, top_k=1, d_ff=64, shared_expert=True),
        moe_every=2,
        dense_d_ff=128,
        dtype="float32",
        block_q=16,
        block_kv=16,
        remat=False,
    )

"""Hand-written Hopper kernels for the TPU kernels on the port's path, each
with its plain PyTorch version (``ref.py``) and a launch counter.

    B1  quantize.quantize_cuda      <- repro/kernels/quantize.py quantize_pallas
    B2  fused_topk.fused_topk_cuda  <- repro/kernels/fused_topk.py fused_topk_pallas
    B3  fused_topk.fused_topk4_cuda <- repro/kernels/fused_topk.py fused_topk4_pallas
    B4  adc.fused_adc_cuda          <- repro/kernels/adc.py fused_adc_pallas
    B5  adc.fused_adc4_cuda         <- repro/kernels/adc.py fused_adc4_pallas

Sources live in ``csrc/`` and are built at first use (``_build.py``).
"""

from __future__ import annotations

from repro_torch.kernels import adc, fused_topk, quantize


def launch_counts() -> dict[str, int]:
    """Kernel launches on CUDA tensors since the last reset, per kernel."""
    return {**quantize.LAUNCHES, **fused_topk.LAUNCHES, **adc.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (quantize.LAUNCHES, fused_topk.LAUNCHES, adc.LAUNCHES):
        for name in counts:
            counts[name] = 0

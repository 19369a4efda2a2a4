"""Hand-written Hopper kernels for the TPU kernels on the port's path, each
with its plain PyTorch version (``ref.py``) and a launch counter.

    B1  quantize.quantize_cuda      <- repro/kernels/quantize.py quantize_pallas
    B2  fused_topk.fused_topk_cuda  <- repro/kernels/fused_topk.py fused_topk_pallas
    B3  fused_topk.fused_topk4_cuda <- repro/kernels/fused_topk.py fused_topk4_pallas
    B4  adc.fused_adc_cuda          <- repro/kernels/adc.py fused_adc_pallas
    B5  adc.fused_adc4_cuda         <- repro/kernels/adc.py fused_adc4_pallas
    B6  qmip.qmip_cuda              <- repro/kernels/qmip.py qmip_pallas
    B7  ql2.ql2_cuda                <- repro/kernels/ql2.py ql2_pallas
    B8  packed.qmip4_cuda           <- repro/kernels/packed.py qmip4_pallas
        packed.ql24_cuda            <- repro/kernels/packed.py ql24_pallas

Sources live in ``csrc/`` and are built at first use (``_build.py``).
"""

from __future__ import annotations

from repro_torch.kernels import adc, fused_topk, packed, ql2, qmip, quantize

_COUNTERS = (quantize.LAUNCHES, fused_topk.LAUNCHES, adc.LAUNCHES,
             qmip.LAUNCHES, ql2.LAUNCHES, packed.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches on CUDA tensors since the last reset, per kernel."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0

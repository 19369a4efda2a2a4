"""B1: Eq. 1 clamped-linear quantization, fp32 -> int8 (port of the TPU
kernel ``repro.kernels.quantize.quantize_pallas``).

``quantize_cuda`` launches ``csrc/quantize.cu`` for CUDA tensors; a CPU
tensor takes the plain version (``ref.quantize_ref``), and only because
it lies on the CPU.  Nothing catches a failed build or launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: kernel launches on CUDA tensors (plain versions do not count)
LAUNCHES = {"quantize": 0}


def quantize_cuda(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  zero: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """[N, d] f32 + per-dim constants -> [N, d] int8 codes (Eq. 1)."""
    if bits > 8:
        raise ValueError("this kernel stores int8; use core.quant for wider codes")
    if x.device.type in _ref.PLAIN:
        return _ref.quantize_ref(x, lo, hi, zero, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"quantize: x must be [N, d], got {tuple(x.shape)}")
    n, d = x.shape
    x = x.to(torch.float32).contiguous()
    consts = [c.to(device=x.device, dtype=torch.float32).reshape(d).contiguous()
              for c in (lo, hi, zero)]
    out = torch.empty((n, d), dtype=torch.int8, device=x.device)
    if n == 0:
        return out
    rc = _build.lib("quantize").rt_quantize(
        x.data_ptr(), consts[0].data_ptr(), consts[1].data_ptr(),
        consts[2].data_ptr(), out.data_ptr(), n, d, bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantize")
    _build.count(LAUNCHES, "quantize")
    return out

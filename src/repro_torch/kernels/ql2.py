"""B7: the int8 negated squared-L2 score matrix (port of the TPU kernel
``repro.kernels.ql2.ql2_pallas``).

    out[i, j] = -( |q_i|^2 + |x_j|^2 - 2 q_i . x_j )   (int32)

``ql2_cuda`` launches the L2 form of B6's tensor-core kernel
(``csrc/qscore.cu``) for CUDA tensors, which sums both norms from the
fragments it multiplies, as ``_ql2_kernel`` recomputes them per tile; a CPU
tensor takes the plain version (``ref.ql2_ref``), and only because it lies
on the CPU.  A CUDA tensor either launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _qscore
from repro_torch.kernels import ref as _ref

#: kernel launches on CUDA tensors (plain versions do not count)
LAUNCHES = {"ql2": 0}


def ql2_plain(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """Plain B7: [Q, d] x [N, d] int -> [Q, N] int32 negated squared L2."""
    return _ref.ql2_ref(q_codes, x_codes)


def ql2_cuda(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """B7: [Q, d] int8 x [N, d] int8 -> [Q, N] int32 negated squared L2."""
    if x_codes.device.type in _ref.PLAIN:
        return ql2_plain(q_codes, x_codes)
    return _qscore.launch("ql2", LAUNCHES, packed=False, l2=True,
                          q0=q_codes, q1=None, x=x_codes)

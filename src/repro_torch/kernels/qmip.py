"""B6: the int8 inner-product score matrix (port of the TPU kernel
``repro.kernels.qmip.qmip_pallas``).

``qmip_cuda`` launches ``csrc/qscore.cu`` for CUDA tensors; a CPU tensor
takes the plain version (``ref.qmip_ref``), and only because it lies on
the CPU.  A CUDA tensor either launches the kernel or raises: nothing
falls back.  The kernel's design notes are in the CUDA source.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _qscore
from repro_torch.kernels import ref as _ref

#: kernel launches on CUDA tensors (plain versions do not count)
LAUNCHES = {"qmip": 0}


def qmip_plain(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """Plain B6: [Q, d] x [N, d] int -> [Q, N] int32, exact on any device
    (on CUDA a float64 product in slabs of 2^20 corpus rows)."""
    return _ref.qmip_ref(q_codes, x_codes)


def qmip_cuda(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """B6: [Q, d] int8 x [N, d] int8 -> [Q, N] int32 inner products."""
    if x_codes.device.type == "cpu":
        return qmip_plain(q_codes, x_codes)
    return _qscore.launch("qmip", LAUNCHES, packed=False, l2=False,
                          q0=q_codes, q1=None, x=x_codes)

"""B8: score matrices over packed-int4 codes (port of the TPU kernels
``repro.kernels.packed.qmip4_pallas`` / ``ql24_pallas``), and the nibble
helpers.

A packed byte holds dims (2t, 2t+1) as (lo, hi) nibbles, so

    q . unpack(x)  =  q_even . lo  +  q_odd . hi

``qmip4_cuda`` / ``ql24_cuda`` launch ``csrc/qscore.cu`` for CUDA tensors
on the pre-split query halves, unpacking the nibbles in registers; a CPU
tensor takes the plain version beside each (``ref.qmip4_ref`` /
``ref.ql24_ref``), and only because it lies on the CPU.  B3
(``fused_topk.fused_topk4_cuda``) scores the same halves inside its fused
top-k scan (``csrc/fused_topk.cu``).  These helpers split and merge the
query halves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _qscore
from repro_torch.kernels import ref as _ref

#: kernel launches on CUDA tensors, per kernel (plain versions do not count)
LAUNCHES = {"qmip4": 0, "ql24": 0}


def split_nibble_queries(q_codes: torch.Tensor):
    """[Q, d] int4-valued codes -> the (even, odd) dim halves [Q, d/2],
    contiguous views of one [2, Q, d/2] copy (a single copy kernel on
    CUDA, where it precedes every packed-int4 launch)."""
    q_rows, d = q_codes.shape
    assert d % 2 == 0, q_codes.shape
    return q_codes.reshape(q_rows, d // 2, 2).permute(2, 0, 1).contiguous(
    ).unbind(0)


def merge_nibble_queries(q_even: torch.Tensor, q_odd: torch.Tensor):
    """Inverse of :func:`split_nibble_queries`: interleave back to [Q, d]."""
    return torch.stack([q_even, q_odd], dim=-1).reshape(q_even.shape[0], -1)


def qmip4_plain(q_even, q_odd, packed) -> torch.Tensor:
    """Plain B8a: the unpacked corpus through ``ref.qmip4_ref``."""
    return _ref.qmip4_ref(merge_nibble_queries(q_even, q_odd), packed)


def ql24_plain(q_even, q_odd, packed) -> torch.Tensor:
    """Plain B8b: the unpacked corpus through ``ref.ql24_ref``."""
    return _ref.ql24_ref(merge_nibble_queries(q_even, q_odd), packed)


def qmip4_cuda(q_even: torch.Tensor, q_odd: torch.Tensor,
               packed: torch.Tensor) -> torch.Tensor:
    """B8a: [Q, d/2] int8 (x2) vs [N, d/2] uint8 packed -> [Q, N] int32 MIP."""
    if packed.device.type == "cpu":
        return qmip4_plain(q_even, q_odd, packed)
    return _qscore.launch("qmip4", LAUNCHES, packed=True, l2=False,
                          q0=q_even, q1=q_odd, x=packed)


def ql24_cuda(q_even: torch.Tensor, q_odd: torch.Tensor,
              packed: torch.Tensor) -> torch.Tensor:
    """B8b: [Q, d/2] int8 (x2) vs [N, d/2] uint8 packed -> [Q, N] int32
    negated squared L2 (norms from the unpacked nibbles)."""
    if packed.device.type == "cpu":
        return ql24_plain(q_even, q_odd, packed)
    return _qscore.launch("ql24", LAUNCHES, packed=True, l2=True,
                          q0=q_even, q1=q_odd, x=packed)

"""Nibble helpers for packed-int4 codes (port of the unpack half of
``repro.kernels.packed``).

A packed byte holds dims (2t, 2t+1) as (lo, hi) nibbles, so

    q . unpack(x)  =  q_even . lo  +  q_odd . hi

B3 (``fused_topk.fused_topk4_cuda``) scores the pre-split query halves
against the two nibble planes, unpacking them in registers
(``csrc/fused_topk.cu``); these helpers split and merge the query halves.
The score-matrix kernels of the reference module (B8, ``qmip4_pallas`` /
``ql24_pallas``) are not ported yet.
"""

from __future__ import annotations

import torch


def split_nibble_queries(q_codes: torch.Tensor):
    """[Q, d] int4-valued codes -> the (even, odd) dim halves [Q, d/2]."""
    assert q_codes.shape[1] % 2 == 0, q_codes.shape
    return q_codes[:, 0::2].contiguous(), q_codes[:, 1::2].contiguous()


def merge_nibble_queries(q_even: torch.Tensor, q_odd: torch.Tensor):
    """Inverse of :func:`split_nibble_queries`: interleave back to [Q, d]."""
    return torch.stack([q_even, q_odd], dim=-1).reshape(q_even.shape[0], -1)

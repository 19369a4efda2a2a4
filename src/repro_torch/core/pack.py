"""int4 code packing: two 4-bit codes per byte (port of ``repro.core.pack``).

Byte layout identical to the reference: the low nibble holds the even dim,
the high nibble the odd dim, each stored as value + 8 (so [-8, 7] -> [0, 15]).
"""

from __future__ import annotations

import torch


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[N, d] int8 values in [-8, 7] -> [N, d/2] uint8 (two nibbles)."""
    n, d = codes.shape
    assert d % 2 == 0, d
    u = (codes.to(torch.int32) + 8).to(torch.uint8)    # [0, 15]
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., d/2] uint8 -> [..., d] int8 in [-8, 7] (any leading dims)."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = ((packed >> 4) & 0x0F).to(torch.int8) - 8
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_uint4(codes: torch.Tensor) -> torch.Tensor:
    """[N, m] uint values in [0, 15] -> [N, ceil(m/2)] uint8 (odd m pads a
    zero-code column)."""
    u = codes.to(torch.uint8)
    if u.shape[1] % 2:
        u = torch.nn.functional.pad(u, (0, 1))
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """[N, ceil(m/2)] uint8 -> [N, 2*ceil(m/2)] uint8 in [0, 15]."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def qip_scores_packed(q_codes: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """int4 MIP scores: unpack the corpus, then the exact int32 dot, [Q, N]."""
    from repro_torch.core.distances import int_matmul

    return int_matmul(q_codes, unpack_int4(packed))

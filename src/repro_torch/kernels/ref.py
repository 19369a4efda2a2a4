"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

The ground truth every CUDA kernel is held to on the card, and what each
kernel wrapper runs for tensors that lie on the CPU.  They share no code
with the kernels.

Ordering contract (the reference's): results are sorted by f32 score
descending under the IEEE total order (-0.0 < +0.0, as XLA's CPU
``top_k``), ties to the lowest column.  ``torch.topk`` promises no tie
order, so selection is a stable descending sort of an int32 order key.
"""

from __future__ import annotations

import torch

from repro_torch.core import distances as D

NEG = float(torch.finfo(torch.float32).min)


def order_key(s: torch.Tensor) -> torch.Tensor:
    """f32 scores -> int32 keys whose integer order is the IEEE total
    order of the floats (so -0.0 sorts below +0.0, as in XLA's top_k)."""
    v = s.to(torch.float32).contiguous().view(torch.int32)
    return v ^ ((v >> 31) & 0x7FFFFFFF)


def stable_desc(s: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the best ``k`` per row: score desc, lowest column first."""
    _, pos = torch.sort(order_key(s), dim=-1, descending=True, stable=True)
    return pos[..., :k]


def qmip_ref(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """[Q, d] int x [N, d] int -> [Q, N] int32 inner products."""
    return D.qip_scores(q_codes, x_codes)


def ql2_ref(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """[Q, d] int x [N, d] int -> [Q, N] int32 negated squared L2."""
    return D.ql2_scores(q_codes, x_codes)


def _unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """[N, d/2] uint8 -> [N, d] int32 nibbles in [-8, 7] (oracle-local)."""
    lo = (packed & 0x0F).to(torch.int32) - 8
    hi = ((packed >> 4) & 0x0F).to(torch.int32) - 8
    n, half = packed.shape
    return torch.stack([lo, hi], dim=-1).reshape(n, half * 2)


def qmip4_ref(q_codes: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """[Q, d] int x [N, d/2] packed uint8 -> [Q, N] int32 inner products."""
    return qmip_ref(q_codes, _unpack_int4_ref(packed))


def ql24_ref(q_codes: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """[Q, d] int x [N, d/2] packed uint8 -> [Q, N] int32 negated sq-L2."""
    return ql2_ref(q_codes, _unpack_int4_ref(packed))


def _unpack_uint4_ref(packed: torch.Tensor) -> torch.Tensor:
    """[N, m/2] uint8 -> [N, m] int32 unsigned nibbles in [0, 15]."""
    lo = (packed & 0x0F).to(torch.int32)
    hi = ((packed >> 4) & 0x0F).to(torch.int32)
    n, half = packed.shape
    return torch.stack([lo, hi], dim=-1).reshape(n, half * 2)


def adc_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[Q, M, K] int LUT x [N, M] uint8 codewords -> [Q, N] int32 ADC.

    The asymmetric-distance oracle: gather each row's per-subspace LUT
    entry and sum — ``s[q, n] = sum_m lut[q, m, codes[n, m]]``.  It
    gathers a [Q, M, N] tensor, so it is for small shapes; the kernels'
    plain versions (``kernels/adc.py``) sum subspace by subspace.
    """
    idx = codes.T[None].to(torch.int64)                 # [1, M, N]
    return torch.sum(
        torch.take_along_dim(lut.to(torch.int32), idx, dim=2), dim=1
    ).to(torch.int32)


def adc4_ref(lut: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """[Q, M, K] int LUT x [N, M/2] packed uint8 nibbles -> [Q, N] int32.

    ``lut``'s subspace axis must already cover the unpacked (even) width;
    a zero LUT slice for an odd-m pad column keeps the sum unchanged.
    """
    return adc_ref(lut, _unpack_uint4_ref(packed))


def topk_ref(scores: torch.Tensor, k: int, n_valid: int | None = None):
    """Exact top-k over a full [Q, N] score matrix.

    Columns >= n_valid (padding) and NEG-masked columns come back as
    (NEG, -1) — the same contract the fused kernels honor.
    """
    s = scores.to(torch.float32)
    if n_valid is not None and n_valid < s.shape[1]:
        s = s.clone()
        s[:, n_valid:] = NEG
    pos = stable_desc(s, k)
    top_s = torch.gather(s, 1, pos)
    top_i = torch.where(top_s > NEG, pos, -1).to(torch.int32)
    return top_s, top_i


def quantize_ref(x, lo, hi, zero, bits: int = 8) -> torch.Tensor:
    """Eq. 1 clamped linear quantization, elementwise (reference op order:
    subtract, times 2^B, IEEE divide, round half to even, clip)."""
    span = torch.clamp_min(hi - lo, 1e-12)
    q = torch.round((2.0 ** bits) * (x.to(torch.float32) - zero) / span)
    return torch.clamp(q, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1).to(torch.int8)

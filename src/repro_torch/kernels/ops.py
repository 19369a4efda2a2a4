"""Public wrappers over the kernels (port of ``repro.kernels.ops``, the
``quantize`` and ``fused_topk`` half).

Dispatch goes by the tensor's device, not by backend: a CUDA tensor runs
the hand-written kernel (B1, B2 or B3) and a CPU tensor its plain version
(``ref.py``).  The kernels mask ragged (Q, N) themselves, so nothing is
padded to tile multiples here; what stays is the reference's interface:
``k = min(k, N)``, the even/odd query split for packed int4 codes
(``repro/kernels/ops.py:155``), and the optional [N] mask.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_topk as _fused
from repro_torch.kernels import packed as _packed
from repro_torch.kernels import quantize as _quantize

split_nibble_queries = _packed.split_nibble_queries


def fused_query_tile(k: int = 100, q: int = _fused.BQ) -> int:
    """Query rows per fused-kernel block — the corpus re-stream granularity
    the engine's ``bytes_read`` accounting derives from."""
    return _fused.query_tile(k, q)


def fused_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str,
    *,
    packed: bool = False,
    mask: torch.Tensor | None = None,
):
    """Streaming fused score + top-k: ([Q, k] f32 scores, [Q, k] i32 ids).

    ``metric`` is ``ip`` or ``l2`` (angular takes the engine's scan).  With
    ``packed=True``, ``x`` is [N, d/2] uint8 int4 codes and ``q`` full-width
    [Q, d] int4-valued int8.  An optional [N] ``mask`` (nonzero = allowed)
    joins the pad fence: filtered rows die like pad rows.
    """
    assert metric in ("ip", "l2"), metric
    k = min(k, x.shape[0])
    mask = None if mask is None else mask.to(x.device)
    if packed:
        qe, qo = _packed.split_nibble_queries(q)
        return _fused.fused_topk4_cuda(qe, qo, x.contiguous(), k=k,
                                       metric=metric, mask=mask)
    return _fused.fused_topk_cuda(q.contiguous(), x.contiguous(), k=k,
                                  metric=metric, mask=mask)


def quantize(
    x: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    zero: torch.Tensor,
    *,
    bits: int = 8,
) -> torch.Tensor:
    """Eq. 1 corpus compression [N, d] f32 -> int8 (B1)."""
    return _quantize.quantize_cuda(x, lo, hi, zero, bits=bits)

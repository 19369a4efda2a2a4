"""Public wrappers over the kernels (port of ``repro.kernels.ops``:
``quantize``, the score matrices ``qmip`` / ``ql2`` / ``qmip4`` /
``ql24``, ``fused_topk`` and ``fused_adc_topk``).

Dispatch goes by the tensor's device, not by backend: a CUDA tensor runs
the hand-written kernel (B1-B8) and a CPU tensor its plain version (as
does a meta tensor at B1 and B6-B8, whose plain version computes shapes
only: ``ref.PLAIN``).  The
reference's ``use_pallas`` / ``interpret`` switches choose between a TPU
kernel and its XLA form, which has no counterpart here, so they are not
carried over.  The kernels mask ragged (Q, N) themselves, so nothing is
padded to tile multiples here; what stays is the reference's interface:
``k = min(k, N)``, the even/odd query split for packed int4 codes
(``repro/kernels/ops.py:155``), the odd-M zero LUT slice and the even/odd
LUT split for packed 4-bit PQ codes (``repro/kernels/ops.py:319-335``),
and the optional [N] mask.  ``fused_topk`` / ``fused_adc_topk`` take a
tuning table's layout (``bq`` query rows a block, ``bn`` corpus rows a
split); ``fused_query_tile`` / ``fused_adc_query_tile`` answer table-first,
then with the layout's own choice (``fused_topk.layout`` /
``adc.adc_layout``, the one record of the untuned layout).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import adc as _adc
from repro_torch.kernels import fused_topk as _fused
from repro_torch.kernels import packed as _packed
from repro_torch.kernels import ql2 as _ql2
from repro_torch.kernels import qmip as _qmip
from repro_torch.kernels import quantize as _quantize
from repro_torch.tune import table as _tune

split_nibble_queries = _packed.split_nibble_queries

# -- registered fallback rows: the dispatch floor (tuned table > these rows).
# They name the implementation only: a fused family runs its kernel at the
# layout's own rule, the scan at the caller's chunk (SearchParams.chunk)
for _family in _tune.FUSED_FAMILIES:
    _tune.register_fallback(_family, _tune.TuneConfig("fused"))
_tune.register_fallback("scan", _tune.TuneConfig("scan"))


def qmip(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """int8 MIP scores [Q, N] int32 (B6)."""
    return _qmip.qmip_cuda(q_codes.contiguous(), x_codes.contiguous())


def ql2(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """int8 negated squared-L2 scores [Q, N] int32 (B7)."""
    return _ql2.ql2_cuda(q_codes.contiguous(), x_codes.contiguous())


def qmip4(q_codes: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """int4 MIP scores [Q, N] int32 over bit-packed corpus codes (B8).

    ``q_codes`` are full-width [Q, d] int4-valued int8 (queries stay
    unpacked: they are tiny); ``packed`` is [N, d/2] uint8.
    """
    qe, qo = _packed.split_nibble_queries(q_codes)
    return _packed.qmip4_cuda(qe, qo, packed.contiguous())


def ql24(q_codes: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """int4 negated squared-L2 scores [Q, N] int32 over packed codes (B8)."""
    qe, qo = _packed.split_nibble_queries(q_codes)
    return _packed.ql24_cuda(qe, qo, packed.contiguous())


def fused_query_tile(q: int, n: int, d: int, *, metric: str = "ip",
                     bits: int = 8, packed: bool = False,
                     k: int = 100) -> int:
    """Query rows per fused-kernel block — the corpus re-stream granularity
    the engine's ``bytes_read`` accounting derives from: the installed
    TuneTable's entry for the workload first, else ``fused_topk.layout``'s
    choice (fp32 rows: ``bits=32``; ``d`` is the vector width)."""
    kernel = "packed" if packed else "fused_topk"
    cfg = _tune.lookup(kernel, metric, bits, q, n, d)
    if cfg is not None and cfg.bq is not None:
        return cfg.bq
    kind = (_fused.KIND_F32 if bits == 32 else
            _fused.KIND_I4 if packed else _fused.KIND_I8)
    width = -(-d // 2) if packed else d
    return _fused.layout(kind, q, n, min(k, n), width).bq


def fused_adc_query_tile(q: int, n: int, m: int, *, metric: str = "ip",
                         bits: int = 8, k: int = 100) -> int:
    """Query rows per fused-ADC block (each holds its queries' LUTs):
    table-first, then ``adc_layout``'s choice for the batch."""
    cfg = _tune.lookup("fused_adc", metric, bits, q, n, m)
    if cfg is not None and cfg.bq is not None:
        return cfg.bq
    code_bytes = -(-m // 2) if bits == 4 else m
    return _adc.adc_layout(min(k, n), code_bytes, bits, q, n).bq


def fused_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str,
    *,
    packed: bool = False,
    mask: torch.Tensor | None = None,
    bq: int | None = None,
    bn: int | None = None,
):
    """Streaming fused score + top-k: ([Q, k] f32 scores, [Q, k] i32 ids).

    ``metric`` is ``ip`` or ``l2`` (angular takes the engine's scan).  With
    ``packed=True``, ``x`` is [N, d/2] uint8 int4 codes and ``q`` full-width
    [Q, d] int4-valued int8.  An optional [N] ``mask`` (nonzero = allowed)
    joins the pad fence: filtered rows die like pad rows.  ``bq`` / ``bn``
    override the kernel's launch layout (``kernels/fused_topk.layout``).
    """
    assert metric in ("ip", "l2"), metric
    k = min(k, x.shape[0])
    mask = None if mask is None else mask.to(x.device)
    if packed:
        qe, qo = _packed.split_nibble_queries(q)
        return _fused.fused_topk4_cuda(qe, qo, x.contiguous(), k=k,
                                       metric=metric, mask=mask, bq=bq, bn=bn)
    return _fused.fused_topk_cuda(q.contiguous(), x.contiguous(), k=k,
                                  metric=metric, mask=mask, bq=bq, bn=bn)


def fused_adc_topk(
    lut: torch.Tensor,
    codes: torch.Tensor,
    k: int,
    *,
    packed: bool = False,
    mask: torch.Tensor | None = None,
    bq: int | None = None,
    bn: int | None = None,
):
    """Streaming fused ADC + top-k: ([Q, k] f32 scores, [Q, k] i32 ids).

    ``lut`` is the [Q, M, K] int8-quantized lookup table (K = codewords
    per subspace); ``codes`` is [N, M] uint8, or — with ``packed=True`` —
    [N, ceil(M/2)] uint8 two nibbles per byte (an odd logical M was padded
    with a zero-code column at pack time; the LUT grows a matching zero
    subspace slice here, so the pad contributes nothing).  An optional
    [N] ``mask`` (nonzero = allowed) joins the pad fence.  ``bq`` / ``bn``
    override the kernel's launch layout (``kernels/adc.adc_layout``).
    """
    Q, m, n_codewords = lut.shape
    k = min(k, codes.shape[0])
    mask = None if mask is None else mask.to(codes.device)
    codes = codes.contiguous()
    if packed:
        if m < 2 * codes.shape[1]:                 # odd-M zero-code pad column
            lut = torch.nn.functional.pad(lut, (0, 0, 0, 2 * codes.shape[1] - m))
        le = lut[:, 0::2, :].reshape(Q, -1).contiguous()
        lo = lut[:, 1::2, :].reshape(Q, -1).contiguous()
        return _adc.fused_adc4_cuda(le, lo, codes, k=k, mask=mask, bq=bq,
                                    bn=bn)
    return _adc.fused_adc_cuda(lut.reshape(Q, -1).contiguous(), codes, k=k,
                               n_codewords=n_codewords, mask=mask, bq=bq,
                               bn=bn)


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

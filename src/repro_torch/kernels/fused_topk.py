"""B2 and B3: fused corpus scan + running top-k (port of the TPU kernels
``repro.kernels.fused_topk.fused_topk_pallas`` / ``fused_topk4_pallas``).

``fused_topk_cuda`` (int8 or fp32 codes) and ``fused_topk4_cuda`` (packed
int4) launch ``csrc/fused_topk.cu`` for CUDA tensors; a CPU tensor takes the
plain version beside each, and only because it lies on the CPU.  A CUDA
tensor either launches the kernel or raises: nothing falls back.

Contract (the reference's): ([Q, k] f32 scores, [Q, k] i32 ids) sorted
best-first by (f32 score desc, id asc); rows with id >= n_valid and rows
whose optional [N] ``mask`` is 0 never appear, and slots without a
candidate hold (float32 min, -1).  The kernel's design notes are in the
CUDA source.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distances as D
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed import merge_nibble_queries

#: corpus rows per pass-1 tile of the fp32 scan (``F32Cfg::BN``)
BN = 256
#: dynamic shared memory one block may use on the H100 (227 KB), and an
#: SM's whole shared memory, of which each resident block also takes 1 KB
SMEM_MAX = 232448
SM_SMEM = 233472

NEG = _ref.NEG

#: threads a block of pass 2 (``NT``)
NT = 256

#: blocks the ADC gather kernel's pass 1 aims for, four per SM on 132 SMs
#: (the scans here: as many as are resident at once), and the fewest
#: corpus rows worth one split
_TARGET_BLOCKS = 528
_SMS = 132
_MIN_SPLIT_ROWS = 2048

KIND_F32, KIND_I8, KIND_I4 = 0, 1, 2

#: B2 int8 and B3 (``i8_topk_kernel``): corpus rows a tile, ring stages,
#: bytes of a row a stage (256 int8 bytes, 128 packed-int4 bytes: 256 dims
#: either way) and, with its 16-byte pad, of a staged row
I8_BM = 32
I8_STAGES = 4
I8_KC = 256
I4_KC = 128

#: kernel launches on CUDA tensors, per variant (plain versions do not count)
LAUNCHES = {"fused_topk_int8": 0, "fused_topk_fp32": 0, "fused_topk4": 0}


class Layout(NamedTuple):
    """One launch of ``rt_fused_topk``: queries a block, candidate keys a
    query, corpus splits, and the global-memory scratch in keys (0: none)
    for the pass-1 buffers (``gbuf``) and the pass-2 merge (``mbuf``)."""
    bq: int
    cap: int
    splits: int
    gbuf_keys: int
    mbuf_keys: int


def _pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def i8_cap(k: int) -> int:
    """Keys of one candidate list of the int8 / int4 scan (a warp's, per
    query): k kept keys, one 32-row tile of inserts and at least 64 more,
    so a list is sorted down to k at most once per 64 survivors.  The
    launch layout is chosen here only; the CUDA source takes it as
    arguments and rejects a list that could overflow."""
    return _pow2(k + 96)


def f32_cap(k: int) -> int:
    """Keys of one candidate list of the fp32 scan (a warp's, per query
    and row group): k kept keys, one round of 32 inserts and at least 64
    more, so a list is sorted down to k at most once per 64 survivors."""
    return _pow2(k + 96)


def f32_batch_tile(q: int) -> int:
    """Query rows per block of the fp32 scan that the arithmetic asks for:
    32 (4 x 8 accumulators a thread), 8 for batches of at most 16, and 1
    for at most 4 (the warps then split the rows)."""
    return 1 if q <= 4 else 8 if q <= 16 else 32


def f32_lists(bq: int) -> int:
    """Candidate lists of an fp32 block: one per query, or at one query a
    block one per warp (8 row groups)."""
    return 8 if bq == 1 else bq


def f32_tile(bq: int) -> tuple[int, int, int]:
    """(corpus rows a tile, ring stages, floats a staged row with its pad)
    of the fp32 block at ``bq`` queries (``F32Cfg`` in the CUDA source):
    256 rows, 2 stages, 16 floats a stage (rows padded to 20) at 32
    queries, else 32 (padded to 36)."""
    return (256, 2, 20) if bq >= 32 else (256, 2, 36)


def f32_smem_bytes(bq: int, cap: int, gbuf: bool) -> int:
    """Shared memory of one fp32 pass-1 block (``f32_smem_bytes`` in the
    CUDA source): the ring, thresholds, the lists unless in global memory,
    |x|^2, |q|^2, counts."""
    lists = f32_lists(bq)
    bn, stages, row = f32_tile(bq)
    return (stages * (bq + bn) * row * 4 + lists * 8
            + (0 if gbuf else lists * cap * 8) + bn * 4 + bq * 4
            + lists * 4 + bq * 4)


def f32_query_tile(k: int, q: int) -> tuple[int, bool]:
    """(query rows per fp32 block, lists in global memory): the batch's
    tile, narrowed (32 -> 8) only where its lists do not fit in shared
    memory at this k; past that the lists move to global memory."""
    cap = f32_cap(k)
    bq = f32_batch_tile(q)
    if f32_smem_bytes(bq, cap, False) > SMEM_MAX and bq == 32:
        bq = 8
    return bq, f32_smem_bytes(bq, cap, False) > SMEM_MAX


def f32_blocks_per_sm(bq: int, cap: int, gbuf: bool) -> int:
    """Resident fp32 blocks an SM: two (the launch bounds hold a thread to
    128 registers) where shared memory takes both, else one."""
    return 2 if 2 * (f32_smem_bytes(bq, cap, gbuf) + 1024) <= SM_SMEM else 1


def i8_query_tile(q: int) -> int:
    """Query rows per int8 / int4 block (``WN`` warps of 8 queries in the
    CUDA source): 32 (4 warps), 16 for batches of at most 16 and 8 for at
    most 8 (one warp)."""
    return 8 if q <= 8 else 16 if q <= 16 else 32


def i8_qrow(width: int, i4: bool = False) -> int:
    """Bytes of one resident query row (of one plane for int4) of the
    block: the row's ``width`` bytes rounded up to KC-byte chunks, and a
    16-byte pad."""
    kc = I4_KC if i4 else I8_KC
    return -(-width // kc) * kc + 16


def i8_smem_bytes(bq: int, cap: int, gbuf: bool, width: int,
                  i4: bool = False) -> int:
    """Shared memory of one int8 (int4) pass-1 block (``i8_smem_bytes`` in
    the CUDA source): the ring of 32-row tiles, the block's queries (two
    planes for int4), the ring's mbarriers, thresholds, the lists unless
    in global memory, |q|^2, counts, flags (and the queries' sums)."""
    kc = I4_KC if i4 else I8_KC
    return (I8_STAGES * (I8_BM * (kc + 16) + 16)
            + (2 if i4 else 1) * bq * i8_qrow(width, i4)
            + bq * 8 + (0 if gbuf else bq * cap * 8) + bq * (16 if i4 else 12))


def i8_blocks_per_sm(bq: int, cap: int, gbuf: bool, width: int,
                     i4: bool = False) -> int:
    """Resident int8 (int4) blocks an SM: as many as shared memory allows
    (each block also takes 1 KB), up to the launch bounds' count (two
    blocks of 32 queries, four of fewer), for which registers are held: at
    k=100, d=256 four blocks of 8 queries, three of 16, two of 32 (int4:
    four, four, two)."""
    fit = SM_SMEM // (i8_smem_bytes(bq, cap, gbuf, width, i4) + 1024)
    return max(1, min(fit, 2 if bq == 32 else 4))


def i8_query_layout(q: int, k: int, width: int,
                    i4: bool = False) -> tuple[int, bool]:
    """(query rows per int8 / int4 block, lists in global memory): the
    batch's tile with its lists in shared memory where they fit, else in
    global memory; a row too wide for 32 resident queries takes 8.  Where
    the lists of a 32-query block leave room for one block an SM (160 < k
    <= 416 at d = 256), blocks of 8 queries, three or four an SM, scan
    faster (PERF.md: 15.4 against 19.4 ms at k=400, int8)."""
    cap = i8_cap(k)
    tile = i8_query_tile(q)
    if (tile == 32 and i8_smem_bytes(32, cap, False, width, i4) <= SMEM_MAX
            and i8_blocks_per_sm(32, cap, False, width, i4) < 2):
        tile = 8
    for bq in dict.fromkeys((tile, 8)):
        for gbuf in (False, True):
            if i8_smem_bytes(bq, cap, gbuf, width, i4) <= SMEM_MAX:
                return bq, gbuf
    raise ValueError(f"fused_topk: rows of {width} bytes are too wide for "
                     "the int scan's resident queries")


def merge_in_shared(k: int) -> bool:
    """Whether pass 2's buffer of next_pow2(k + 256) keys fits in shared
    memory (true up to k = 16128)."""
    return _pow2(k + NT) * 8 + 16 <= SMEM_MAX


def _split_count(qblocks: int, n: int, k: int, target: int) -> int:
    s = -(-target // qblocks)
    # a split holds at least 2048 rows and 2k rows
    return max(1, min(s, -(-n // max(_MIN_SPLIT_ROWS, 2 * k)), 65535))


def layout(kind: int, q: int, n: int, k: int, d: int = 0) -> Layout:
    """The whole launch layout of one fused scan; the wrapper's one place
    that decides it (the CUDA source takes it as arguments).  ``d`` (the
    row width in bytes: d int8 codes, d/2 packed-int4 bytes) matters to
    the int scans only, whose queries stay in shared memory."""
    if kind == KIND_F32:
        (bq, gbuf), cap = f32_query_tile(k, q), f32_cap(k)
        lists, per_sm = f32_lists(bq), f32_blocks_per_sm(bq, cap, gbuf)
    else:
        assert d > 0, "the int layout needs the row width d"
        i4 = kind == KIND_I4
        (bq, gbuf), cap = i8_query_layout(q, k, d, i4), i8_cap(k)
        lists, per_sm = bq, i8_blocks_per_sm(bq, cap, gbuf, d, i4)
    qblocks = -(-q // bq)
    # one wave: as many blocks as are resident at once, never a partial
    # second wave
    splits = max(1, min(per_sm * _SMS // qblocks,
                        -(-n // max(_MIN_SPLIT_ROWS, 2 * k)), 65535))
    gbuf = qblocks * splits * lists * cap if gbuf else 0
    mbuf = 0 if merge_in_shared(k) else q * _pow2(k + NT)
    return Layout(bq, cap, splits, gbuf, mbuf)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _masked_topk(s: torch.Tensor, k: int, mask):
    if mask is not None:
        s = torch.where(mask.to(device=s.device, dtype=torch.bool)[None, :],
                        s.to(torch.float32), NEG)
    return _ref.topk_ref(s, k, s.shape[1])


def fused_topk_plain(q, x, *, k: int, metric: str, mask=None):
    """Plain B2: full score matrix + stable top-k (``ref.py`` oracles)."""
    if q.dtype.is_floating_point:
        s = D.scores(q, x, metric)
    else:
        s = _ref.qmip_ref(q, x) if metric == "ip" else _ref.ql2_ref(q, x)
    return _masked_topk(s, k, mask)


def fused_topk4_plain(q_even, q_odd, packed, *, k: int, metric: str,
                      mask=None):
    """Plain B3 over packed int4 codes."""
    q = merge_nibble_queries(q_even, q_odd)
    s = _ref.qmip4_ref(q, packed) if metric == "ip" else _ref.ql24_ref(q, packed)
    return _masked_topk(s, k, mask)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_topk: {msg}")


def _launch(name: str, kind: int, metric: str, q0, q1, x, mask, k: int,
            width: int):
    _check(metric in ("ip", "l2"), f"metric must be ip or l2, got {metric!r}")
    dev = x.device
    Q, N = q0.shape[0], x.shape[0]
    _check(1 <= k <= N, f"k={k} outside [1, N={N}]")
    _check(N < 2 ** 31, "row ids are int32")
    for t in (q0, q1, x, mask):
        _check(t is None or (t.device == dev and t.is_contiguous()),
               "every tensor must be contiguous and on the corpus's device")
    if mask is not None:
        _check(mask.shape == (N,), f"mask must be [{N}], got {tuple(mask.shape)}")
        mask = mask.to(torch.int8)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    lay = layout(kind, Q, N, k, width)
    part = torch.empty(Q * lay.splits * k, dtype=torch.int64, device=dev)
    gbuf = (torch.empty(lay.gbuf_keys, dtype=torch.int64, device=dev)
            if lay.gbuf_keys else None)
    mbuf = (torch.empty(lay.mbuf_keys, dtype=torch.int64, device=dev)
            if lay.mbuf_keys else None)
    rc = _build.lib("fused_topk").rt_fused_topk(
        kind, int(metric == "l2"), lay.bq, lay.cap, q0.data_ptr(),
        None if q1 is None else q1.data_ptr(), x.data_ptr(),
        None if mask is None else mask.data_ptr(), part.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(),
        None if mbuf is None else mbuf.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), Q, N, width, k, lay.splits,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_topk")
    LAUNCHES[name] += 1
    return out_s, out_i


def fused_topk_cuda(q: torch.Tensor, x: torch.Tensor, *, k: int, metric: str,
                    mask: torch.Tensor | None = None):
    """B2: [Q, d] x [N, d] (both int8 or both fp32) -> top-k, streaming."""
    if x.device.type == "cpu":
        return fused_topk_plain(q, x, k=k, metric=metric, mask=mask)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(q.dim() == 2 and x.dim() == 2 and q.shape[1] == x.shape[1],
           f"shapes {tuple(q.shape)} x {tuple(x.shape)}")
    if x.dtype == torch.int8 and q.dtype == torch.int8:
        kind, name = KIND_I8, "fused_topk_int8"
    elif x.dtype == torch.float32 and q.dtype == torch.float32:
        kind, name = KIND_F32, "fused_topk_fp32"
    else:
        raise ValueError(f"fused_topk: dtypes {q.dtype} x {x.dtype} "
                         "(both int8 or both float32)")
    return _launch(name, kind, metric, q, None, x, mask, k, x.shape[1])


def fused_topk4_cuda(q_even: torch.Tensor, q_odd: torch.Tensor,
                     packed: torch.Tensor, *, k: int, metric: str,
                     mask: torch.Tensor | None = None):
    """B3: [Q, d/2] int8 (x2) vs [N, d/2] uint8 packed int4 -> top-k."""
    if packed.device.type == "cpu":
        return fused_topk4_plain(q_even, q_odd, packed, k=k, metric=metric,
                                 mask=mask)
    _check(packed.device.type == "cuda", f"unsupported device {packed.device}")
    _check(packed.dtype == torch.uint8 and q_even.dtype == torch.int8
           and q_odd.dtype == torch.int8,
           "packed must be uint8 and the query halves int8")
    _check(q_even.shape == q_odd.shape and q_even.dim() == 2
           and q_even.shape[1] == packed.shape[1],
           f"shapes {tuple(q_even.shape)}, {tuple(q_odd.shape)} x "
           f"{tuple(packed.shape)}")
    return _launch("fused_topk4", KIND_I4, metric, q_even, q_odd, packed,
                   mask, k, packed.shape[1])

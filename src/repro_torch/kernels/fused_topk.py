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

import torch

from repro_torch.core import distances as D
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed import merge_nibble_queries

#: query rows per block: 16 for k <= 224, fewer for wider k and tiny batches
BQ = 16
#: corpus rows per pass-1 tile (``BN`` in the CUDA source)
BN = 256
#: largest k the kernels take (the +r32 tail at k=100 asks for depth 400)
K_MAX = 1024

NEG = _ref.NEG

#: threads of a pass-1 block that insert one query's candidates in one
#: round (``ROW_LANES`` in the CUDA source)
ROW_LANES = 64

#: blocks pass 1 aims for (four per SM on 132 SMs), and the fewest corpus
#: rows worth one split
_TARGET_BLOCKS = 528
_MIN_SPLIT_ROWS = 2048

_KIND_F32, _KIND_I8, _KIND_I4 = 0, 1, 2

#: kernel launches on CUDA tensors, per variant (plain versions do not count)
LAUNCHES = {"fused_topk_int8": 0, "fused_topk_fp32": 0, "fused_topk4": 0}


def split_cap(k: int) -> int:
    """Candidate-buffer keys per query in pass 1: room for k kept keys,
    one round of ROW_LANES inserts and about k more, so a buffer is
    compacted roughly once per k threshold-passing candidates.  The launch
    layout is chosen here only; the CUDA source takes it as arguments and
    rejects a buffer that could overflow."""
    cap = 1
    while cap < 2 * k + ROW_LANES:
        cap <<= 1
    return cap


def query_tile(k: int, q: int = BQ) -> int:
    """Query rows per block.  A block keeps one ``split_cap(k)`` buffer per
    query in shared memory, so wider k take fewer queries per block; a
    batch of at most 4 queries takes 4 rather than computing empty rows."""
    cap = split_cap(k)
    if q <= 4 or cap > 1024:
        return 4
    return 16 if cap <= 512 else 8


def n_splits(q: int, n: int, k: int) -> int:
    """Corpus ranges pass 1 splits the scan into (blocks along y)."""
    qblocks = -(-q // query_tile(k, q))
    s = -(-_TARGET_BLOCKS // qblocks)
    return max(1, min(s, -(-n // _MIN_SPLIT_ROWS), 65535))


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
    _check(1 <= k <= K_MAX, f"k={k} outside [1, {K_MAX}] (the kernels' cap)")
    _check(k <= N, f"k={k} exceeds the corpus rows N={N}")
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
    bq = query_tile(k, Q)
    splits = n_splits(Q, N, k)
    part = torch.empty(Q * splits * k, dtype=torch.int64, device=dev)
    rc = _build.lib("fused_topk").rt_fused_topk(
        kind, int(metric == "l2"), bq, split_cap(k), q0.data_ptr(),
        None if q1 is None else q1.data_ptr(), x.data_ptr(),
        None if mask is None else mask.data_ptr(), part.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), Q, N, width, k, splits,
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
        kind, name = _KIND_I8, "fused_topk_int8"
    elif x.dtype == torch.float32 and q.dtype == torch.float32:
        kind, name = _KIND_F32, "fused_topk_fp32"
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
    return _launch("fused_topk4", _KIND_I4, metric, q_even, q_odd, packed,
                   mask, k, packed.shape[1])

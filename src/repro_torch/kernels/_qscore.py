"""The launcher shared by the score-matrix kernels B6-B8 (one CUDA source,
``csrc/qscore.cu``): checks, the query tile, the output, the launch count.

The kernel masks ragged Q, N and d itself, so nothing is padded here; the
[Q, N] int32 output is the one allocation, made once per call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: most queries per block; fewer for a smaller batch (``query_tile``)
BQ = 16
#: corpus rows per output tile (``BN`` in the CUDA source)
BN = 512


def query_tile(q: int) -> int:
    """Queries per block: the smallest power of two >= ``q``, at most 16,
    so a single request (Q=1) does not compute 15 empty rows."""
    bq = 1
    while bq < min(q, BQ):
        bq <<= 1
    return bq


def check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def launch(what: str, launches: dict, *, packed: bool, l2: bool,
           q0: torch.Tensor, q1: torch.Tensor | None,
           x: torch.Tensor) -> torch.Tensor:
    """[Q, width] int8 query rows (``packed``: the even and odd halves
    ``q0`` / ``q1``) against [N, width] int8 rows (``packed``: uint8 bytes
    of two int4 codes) -> [Q, N] int32, on the corpus's CUDA device;
    counts the launch in ``launches[what]``."""
    dev = x.device
    check(dev.type == "cuda", what, f"unsupported device {dev}")
    want = torch.uint8 if packed else torch.int8
    check(x.dtype == want, what, f"corpus must be {want}, got {x.dtype}")
    planes = (q0,) if q1 is None else (q0, q1)
    for t in (*planes, x):
        check(t.dim() == 2, what, f"operands must be 2-D, got {tuple(t.shape)}")
        check(t.device == dev and t.is_contiguous(), what,
              "every tensor must be contiguous and on the corpus's device")
    for t in planes:
        check(t.dtype == torch.int8, what, f"queries must be int8, got {t.dtype}")
        check(t.shape == q0.shape and t.shape[1] == x.shape[1], what,
              f"shapes {[tuple(p.shape) for p in planes]} x {tuple(x.shape)}")
    check(packed == (q1 is not None), what, "packed codes take two query halves")
    Q, N, width = q0.shape[0], x.shape[0], x.shape[1]
    check(Q < 2 ** 31 and width < 2 ** 31, what, "Q and the row width are int32")
    out = torch.empty((Q, N), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return out
    check(width > 0, what, "rows must have at least one byte")
    rc = _build.lib("qscore").rt_qscore(
        int(packed), int(l2), query_tile(Q), q0.data_ptr(),
        None if q1 is None else q1.data_ptr(), x.data_ptr(), out.data_ptr(),
        Q, N, width, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    launches[what] += 1
    return out

"""The launcher shared by the score-matrix kernels B6-B8 (one CUDA source,
``csrc/qscore.cu``): checks, the query tile, the output, the launch count.

B6 and B8a (inner products) run the tensor-core kernel, whose output tile
is ``mma_tiles(Q)``; B7 and B8b (negated squared L2) run the dp4a kernel,
``query_tile(Q)`` queries a block.  Both kernels mask ragged Q, N and d
themselves, so nothing is padded here; the [Q, N] int32 output is the one
allocation, made once per call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: most queries per block of the dp4a kernel (B7, B8b; ``query_tile``)
BQ = 16
#: query tiles of the tensor-core kernel (B6, B8a; ``QT`` in the CUDA source)
MMA_TILES = (8, 16, 32, 64, 128)


def query_tile(q: int) -> int:
    """Queries per block of the dp4a kernel: the smallest power of two >=
    ``q``, at most 16, so a single request (Q=1) does not compute 15 empty
    rows."""
    bq = 1
    while bq < min(q, BQ):
        bq <<= 1
    return bq


def mma_tiles(q: int) -> tuple[int, int]:
    """(queries, corpus rows) of one output tile of the tensor-core kernel:
    the smallest query tile of ``MMA_TILES`` that holds ``q`` (the largest
    past them), so a single query computes 7 empty MMA columns, no more;
    128 corpus rows for 64 queries and more, else 256 (``MmaCfg::BM``)."""
    qt = next((t for t in MMA_TILES if t >= q), MMA_TILES[-1])
    return qt, 128 if qt >= 64 else 256


def check(cond: bool, what: str, msg) -> None:
    """Raise ``ValueError`` unless ``cond``.  ``msg`` is a string, or a
    function returning one where formatting it would cost host time on
    every call (a single-query request is host-bound)."""
    if not cond:
        raise ValueError(f"{what}: {msg() if callable(msg) else msg}")


def launch(what: str, launches: dict, *, packed: bool, l2: bool,
           q0: torch.Tensor, q1: torch.Tensor | None,
           x: torch.Tensor) -> torch.Tensor:
    """[Q, width] int8 query rows (``packed``: the even and odd halves
    ``q0`` / ``q1``) against [N, width] int8 rows (``packed``: uint8 bytes
    of two int4 codes) -> [Q, N] int32, on the corpus's CUDA device;
    counts the launch in ``launches[what]``."""
    dev = x.device
    check(dev.type == "cuda", what, lambda: f"unsupported device {dev}")
    want = torch.uint8 if packed else torch.int8
    check(x.dtype == want, what,
          lambda: f"corpus must be {want}, got {x.dtype}")
    planes = (q0,) if q1 is None else (q0, q1)
    for t in (*planes, x):
        check(t.dim() == 2, what,
              lambda: f"operands must be 2-D, got {tuple(t.shape)}")
        check(t.device == dev and t.is_contiguous(), what,
              "every tensor must be contiguous and on the corpus's device")
    for t in planes:
        check(t.dtype == torch.int8, what,
              lambda: f"queries must be int8, got {t.dtype}")
        check(t.shape == q0.shape and t.shape[1] == x.shape[1], what,
              lambda: f"shapes {[tuple(p.shape) for p in planes]} x "
              f"{tuple(x.shape)}")
    check(packed == (q1 is not None), what, "packed codes take two query halves")
    Q, N, width = q0.shape[0], x.shape[0], x.shape[1]
    check(Q < 2 ** 31 and width < 2 ** 31, what, "Q and the row width are int32")
    out = torch.empty((Q, N), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return out
    check(width > 0, what, "rows must have at least one byte")
    tile = query_tile(Q) if l2 else mma_tiles(Q)[0]
    rc = _build.lib("qscore").rt_qscore(
        int(packed), int(l2), tile, q0.data_ptr(),
        None if q1 is None else q1.data_ptr(), x.data_ptr(), out.data_ptr(),
        Q, N, width, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    launches[what] += 1
    return out

"""The launcher shared by the score-matrix kernels B6-B8 (one CUDA source,
``csrc/qscore.cu``): checks, the query tile, the output, the launch count.

All four run the tensor-core kernel, whose output tile is ``mma_tiles(Q)``;
B7 and B8b (negated squared L2) are its L2 form, which sums both norms from
the fragments it multiplies.  The kernel masks ragged Q, N and d itself, so
nothing is padded here; the [Q, N] int32 output is the one allocation,
made once per call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: query tiles of the tensor-core kernel (``QT`` in the CUDA source)
MMA_TILES = (8, 16, 32, 64, 128)


def mma_tiles(q: int) -> tuple[int, int]:
    """(queries, corpus rows) of one output tile of the tensor-core kernel:
    the smallest query tile of ``MMA_TILES`` that holds ``q`` (the largest
    past them), so a single query computes 7 empty MMA columns, no more;
    128 corpus rows for 64 queries and more, else 256 (``MmaCfg::BM``)."""
    qt = next((t for t in MMA_TILES if t >= q), MMA_TILES[-1])
    return qt, 128 if qt >= 64 else 256


def launch(what: str, launches: dict, *, packed: bool, l2: bool,
           q0: torch.Tensor, q1: torch.Tensor | None,
           x: torch.Tensor) -> torch.Tensor:
    """[Q, width] int8 query rows (``packed``: the even and odd halves
    ``q0`` / ``q1``) against [N, width] int8 rows (``packed``: uint8 bytes
    of two int4 codes) -> [Q, N] int32, on the corpus's CUDA device;
    counts the launch in ``launches[what]``.

    The host time before the launch shows in every call's time (a single
    query's call is mostly host time), so the checks are plain ``if``
    statements, a message is formatted only on failure, and the stream
    comes as a raw handle."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    want = torch.uint8 if packed else torch.int8
    if x.dtype != want:
        raise ValueError(f"{what}: corpus must be {want}, got {x.dtype}")
    if packed != (q1 is not None):
        raise ValueError(f"{what}: packed codes take two query halves")
    planes = (q0,) if q1 is None else (q0, q1)
    for t in (*planes, x):
        if t.dim() != 2:
            raise ValueError(
                f"{what}: operands must be 2-D, got {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous and "
                             "on the corpus's device")
    Q, N, width = q0.shape[0], x.shape[0], x.shape[1]
    for t in planes:
        if t.dtype != torch.int8:
            raise ValueError(f"{what}: queries must be int8, got {t.dtype}")
        if t.shape != q0.shape or t.shape[1] != width:
            raise ValueError(f"{what}: shapes "
                             f"{[tuple(p.shape) for p in planes]} x "
                             f"{tuple(x.shape)}")
    if Q >= 2 ** 31 or width >= 2 ** 31:
        raise ValueError(f"{what}: Q and the row width are int32")
    out = torch.empty((Q, N), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return out
    if width == 0:
        raise ValueError(f"{what}: rows must have at least one byte")
    rc = _build.lib("qscore").rt_qscore(
        int(packed), int(l2), mma_tiles(Q)[0], q0.data_ptr(),
        None if q1 is None else q1.data_ptr(), x.data_ptr(), out.data_ptr(),
        Q, N, width, torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(rc, what)
    launches[what] += 1
    return out

"""Tuning spaces: legal launch layouts and scan chunks per kernel family,
plus the roofline cost model that prunes them before anything is timed
(port of ``repro.tune.space``, re-derived from the port's own kernels).

One space per kernel family:

    fused_topk   B2 over int8 codes (``bits`` 8) or fp32 rows (32)
    packed       B3 over bit-packed int4 codes
    fused_adc    B4 / B5 over PQ codes with int8 LUTs (``d`` = M)
    scan         the plain streaming scan (angular; any metric on the CPU)

On a ``cuda`` backend the fused families enumerate kernel layouts only:
an ip / l2 CUDA store always runs its kernel, so the scan is no candidate
there.  A layout is ``(bq, bn)``: ``bq`` the query rows one block holds
(B2 int8 / B3 8, 16 or 32; B2 fp32 1, 8 or 32; B4 the word kernel's 4 or
8, the gather kernel's 1, 2 or 4 for batches of at most 4; B5 the MMA
kernel's 8, 16 or 32), ``bn`` the corpus rows one split streams (splits =
ceil(n / bn), in place of the one-wave rule, within the layouts' own cap
of a split of at least 2048 and 2k rows, which holds a tuned layout's
partial lists to the untuned one's bound at any k: table keys carry no
k).  The split counts tried are half, one, two and four waves of the block's resident blocks (the layout's
own rule is one wave; a split streams one tile at least), so every
``bq`` is tried at each occupancy.  A layout is legal where the
CUDA source accepts it: ``kernels/fused_topk.layout`` and
``kernels/adc.adc_layout`` raise ``ValueError`` otherwise (shared memory
past ``SMEM_MAX``, a block the source has no instance of, more than 65535
splits, a split shorter than one tile).  The scan family, and every family
on the CPU, where the plain scan is what dispatch runs, enumerate the
reference's chunk ladder.

``estimate`` is napkin math against the H100's published peaks (the
constants below, which ``chip_smoke.py`` imports): max(compute term,
memory term), counting one read of the corpus for every ``bq`` query rows
(each query block streams it) and the scan's pad rows as real bytes.
``prune`` keeps candidates within ``ratio`` x the best estimate; the
measurement decides the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.kernels import adc as _adc
from repro_torch.kernels import fused_topk as _fused
from repro_torch.tune.table import FUSED_FAMILIES, TuneConfig

#: published peaks of one NVIDIA H100 SXM (dense, 700 W)
PEAK_BYTES = 3.35e12        # HBM3, bytes/s
PEAK_INT8 = 1.979e15        # int8 tensor-core ops/s
PEAK_FP32 = 67e12           # fp32 CUDA-core FLOP/s
PEAK_INT32 = 67e12          # int32 CUDA-core adds/s (the ADC gather-sum)

#: kernel families a TuneTable may carry entries for
KERNELS = (*FUSED_FAMILIES, "scan")

#: split counts tried, in waves of the resident blocks (a wave: as many
#: blocks as the card holds at once, the layouts' own rule)
SPLIT_WAVES = (0.5, 1, 2, 4)
#: the scan's chunk ladder (the reference's)
CHUNK_CANDIDATES = (2048, 4096, 8192, 16384, 32768, 65536)
#: the scan chunk dispatch uses without a table (SearchParams.chunk)
DEFAULT_CHUNK = 16384
#: row multiple of the scan's exact-fit chunk
ROW_UNIT = 8


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Workload:
    """One tuning cell: the shape facts dispatch keys on.

    For ``fused_adc``, ``d`` is the number of PQ subspaces M (the LUT's
    middle axis) and ``bits`` the code width {4, 8}, as the dispatch
    lookup keys ADC workloads; elsewhere ``d`` is the vector width and
    ``bits`` the storage width (4, 8, or 32 for fp32 rows)."""

    kernel: str
    metric: str
    bits: int
    q: int
    n: int
    d: int
    k: int = 10

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")
        for name in ("bits", "q", "n", "d", "k"):
            v = getattr(self, name)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"Workload.{name} must be a positive int, "
                                 f"got {v!r}")


def row_bytes(w: Workload) -> int:
    """Streamed bytes per corpus row (codes for ADC, codes or fp32 rows
    for flat)."""
    if w.bits == 4:
        return -(-w.d // 2)
    if w.bits == 8:
        return w.d
    return 4 * w.d


def fused_kind(w: Workload) -> int:
    """The ``rt_fused_topk`` kind of a flat workload."""
    if w.kernel == "packed" or w.bits == 4:
        return _fused.KIND_I4
    return _fused.KIND_F32 if w.bits == 32 else _fused.KIND_I8


def block_rows(kernel: str, bits: int, q: int) -> tuple[int, ...]:
    """The query rows a block of ``kernel``'s CUDA form can hold for a
    batch of q (``TuneTable.check`` refuses any other ``bq``)."""
    if kernel == "fused_adc":
        return _adc.block_rows(bits, q)
    return _fused.block_rows(_fused.KIND_F32 if bits == 32
                             else _fused.KIND_I8)


def kernel_layout(w: Workload, cfg: TuneConfig):
    """The launch layout ``cfg`` gives the workload's kernel; raises
    ``ValueError`` where the CUDA source would refuse it."""
    k = min(w.k, w.n)
    if w.kernel == "fused_adc":
        return _adc.adc_layout(k, row_bytes(w), w.bits, w.q, w.n,
                               cfg.bq, cfg.bn)
    return _fused.layout(fused_kind(w), w.q, w.n, k, row_bytes(w),
                         cfg.bq, cfg.bn)


def tile_rows(w: Workload, lay) -> int:
    """Corpus rows of one pass-1 tile of the layout's kernel (the least
    rows a split may stream unless it streams them all)."""
    if w.kernel == "fused_adc":
        return lay.tile
    if fused_kind(w) == _fused.KIND_F32:
        return _fused.f32_tile(lay.bq)[0]
    return _fused.I8_BM


def resident_blocks(w: Workload, lay) -> int:
    """Blocks of this layout the card holds at once (every SM full)."""
    if w.kernel == "fused_adc":
        cb, gbuf = row_bytes(w), lay.gbuf_keys > 0
        if lay.word:
            per_sm = _adc.w_blocks_per_sm(lay.bq, lay.subsets, lay.cap, cb,
                                          gbuf, lay.lutg)
        elif lay.gather:
            per_sm = _fused._TARGET_BLOCKS // _fused._SMS
        else:
            per_sm = _adc.a4_blocks_per_sm(lay.bq, lay.cap, gbuf, cb)
    elif fused_kind(w) == _fused.KIND_F32:
        per_sm = _fused.f32_blocks_per_sm(lay.bq, lay.cap, lay.gbuf_keys > 0)
    else:
        per_sm = _fused.i8_blocks_per_sm(
            lay.bq, lay.cap, lay.gbuf_keys > 0, row_bytes(w),
            fused_kind(w) == _fused.KIND_I4)
    return per_sm * _fused._SMS


def _fusable(w: Workload, backend: Optional[str]) -> bool:
    """Whether dispatch runs a kernel for the workload on ``backend`` (None:
    the live process's)."""
    if backend is None:
        from repro_torch.runtime import profile as rtprofile

        backend = rtprofile.backend()
    return (backend == "cuda" and w.kernel in FUSED_FAMILIES
            and w.metric in ("ip", "l2"))


def legal(w: Workload, cfg: TuneConfig,
          backend: Optional[str] = None) -> bool:
    if cfg.impl == "scan":
        return (cfg.chunk is not None and cfg.chunk % ROW_UNIT == 0
                and not _fusable(w, backend))
    if not _fusable(w, backend):
        return False
    try:
        kernel_layout(w, cfg)
    except ValueError:
        return False
    return True


def scan_chunks(w: Workload) -> tuple[int, ...]:
    """Chunk ladder for this corpus: every chunk >= n scores identical
    rows (the single-tile path), so the exact-fit ``round_up(n)`` stands in
    for all of them, and is the pad-waste killer for awkward n."""
    ladder = [c for c in CHUNK_CANDIDATES if c < w.n]
    return tuple(sorted(set(ladder + [round_up(w.n, ROW_UNIT)])))


def split_rows(w: Workload, splits: int) -> int:
    """The ``bn`` that gives ``splits`` corpus splits."""
    return -(-w.n // splits)


def candidates(w: Workload,
               backend: Optional[str] = None) -> list[TuneConfig]:
    """Every legal candidate for the workload on ``backend`` (None: the
    live process's): for a fused family on the card, each block the
    kernel holds at each split count of ``SPLIT_WAVES`` (and the default
    layout); the scan's chunk ladder elsewhere."""
    if not _fusable(w, backend):
        return [TuneConfig("scan", chunk=c) for c in scan_chunks(w)]
    out: list[TuneConfig] = []
    # (bq, splits) of the layouts already listed: the layouts' k cap may
    # give two split lengths one split count
    seen: set[tuple[int, int]] = set()
    for bq in block_rows(w.kernel, w.bits, w.q):
        try:
            lay = kernel_layout(w, TuneConfig("fused", bq=bq))
        except ValueError:
            continue
        if not out:                      # the default is legal where any is
            default = default_config(w, backend)
            out.append(default)
            seen.add((default.bq, kernel_layout(w, default).splits))
        wave = max(1, resident_blocks(w, lay) // -(-w.q // lay.bq))
        for f in SPLIT_WAVES:
            bn = max(split_rows(w, max(1, int(wave * f))),
                     min(w.n, tile_rows(w, lay)))
            cfg = TuneConfig("fused", bq=bq, bn=bn)
            if not legal(w, cfg, backend):
                continue
            run = (bq, kernel_layout(w, cfg).splits)
            if run not in seen:
                seen.add(run)
                out.append(cfg)
    return out


def estimate(w: Workload, cfg: TuneConfig) -> float:
    """Roofline seconds: max(operations / peak, bytes / HBM rate), with
    one corpus read for every block of ``bq`` query rows (fused) or the
    scan's pad rows."""
    if w.kernel == "fused_adc":
        ops, peak = float(w.q) * w.n * w.d, PEAK_INT32
    else:
        ops = 2.0 * w.q * w.n * w.d
        peak = PEAK_FP32 if w.bits == 32 else PEAK_INT8
    if cfg.impl == "fused":
        passes = -(-w.q // kernel_layout(w, cfg).bq)
        n_rows = w.n * passes
    else:
        chunk = cfg.chunk or DEFAULT_CHUNK
        n_rows = w.n if w.n <= chunk else round_up(w.n, chunk)
    mem_bytes = n_rows * row_bytes(w) + w.q * w.d
    return max(ops / peak, mem_bytes / PEAK_BYTES)


def prune(w: Workload, cands: Sequence[TuneConfig], *, ratio: float = 4.0,
          keep: Optional[TuneConfig] = None) -> list[TuneConfig]:
    """Drop candidates the cost model says are > ``ratio`` x the best
    estimate; ``keep`` (the default-dispatch config) always survives."""
    if not cands:
        return [keep] if keep is not None else []
    best = min(estimate(w, c) for c in cands)
    out = [c for c in cands if estimate(w, c) <= ratio * best]
    if keep is not None and keep not in out:
        out.append(keep)
    return out


def default_config(w: Workload, backend: Optional[str] = None) -> TuneConfig:
    """What today's table-less dispatch runs for this workload, the honest
    baseline every measured speedup is reported against: on the card, a
    fused family's kernel at its own layout (spelled out as its ``bq`` and
    the ``bn`` that gives its split count); elsewhere the 16384-chunk
    scan.  ``backend`` None: the live process's (``runtime.profile``)."""
    if _fusable(w, backend):
        lay = kernel_layout(w, TuneConfig("fused"))
        return TuneConfig("fused", bq=lay.bq, bn=split_rows(w, lay.splits))
    return TuneConfig("scan", chunk=DEFAULT_CHUNK)

"""B4 and B5: fused ADC scan + running top-k over PQ codes (port of the TPU
kernels ``repro.kernels.adc.fused_adc_pallas`` / ``fused_adc4_pallas``).

``fused_adc_cuda`` (256-codeword codebooks, one uint8 code per subspace)
and ``fused_adc4_cuda`` (16-codeword codebooks, codes packed two per byte)
launch ``csrc/adc.cu`` for CUDA tensors; a CPU tensor takes the plain
version beside each, and only because it lies on the CPU.  A CUDA tensor
either launches the kernel or raises: nothing falls back.

Contract (B2's, the reference's): ([Q, k] f32 scores, [Q, k] i32 ids)
sorted best-first by (f32-cast int32 score desc, id asc); rows whose
optional [N] ``mask`` is 0 never appear, and slots without a candidate
hold (float32 min, -1).  The plain versions sum the LUT subspace by
subspace into one [Q, N] int32 accumulator: the reference oracle
``adc_ref`` gathers a [Q, M, N] tensor, 128 GB at Q=256, M=32, N=4M,
where this needs 4 GB.  Integer sums do not depend on order, so the two
agree bit for bit.  The kernels' design notes are in the CUDA source;
``adc_layout`` chooses the kernel and its launch layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_topk as _fused

#: B4's queries a block on ``adc_word_kernel`` at pq32, k <= 160 (two
#: groups of 4 queries; ``adc_layout``'s choice)
BQ = 8
#: code rows of a pass-1 tile of the gather kernel (``adc_split_kernel``,
#: batches of at most 4 queries) at 4 queries a block (``tile_rows`` in
#: the CUDA source: 512 at 2, 1024 at 1)
BN = 256
#: 32-bit code words the gather kernel stages a chunk (``DKC``)
_DKC = 8
#: dynamic shared memory one block may use on the H100 (227 KB), and an
#: SM's whole shared memory
SMEM_MAX = _fused.SMEM_MAX
SM_SMEM = _fused.SM_SMEM

#: B5 (``adc4_mma_kernel``): code rows a tile, ring stages, code bytes of a
#: row a stage and the staged row stride
A4_BM = 32
A4_STAGES = 4
A4_KCB = 64
A4_SROW = A4_KCB + 16

#: B4 from 5 queries on (``adc_word_kernel``): rows a tile (two a lane),
#: subspaces (code bytes) a stage, ring stages, consumer warps a block at
#: most, and the LUT bytes of one group of 4 queries over one chunk of 32
#: subspaces (biased u8 entries, 256 codewords)
W_BM = 64
W_CW = 32
W_STAGES = 8
W_MAXWARPS = 8
W_CHUNK_BYTES = 256 * W_CW * 4
#: (queries a block, warps a query group) in order of preference
W_TILES = ((8, 2), (4, 4), (4, 2), (8, 1), (4, 1))
#: resident consumer warps an SM past which more buy nothing here
W_ENOUGH_WARPS = 8

#: kernel launches on CUDA tensors, per variant (plain versions do not count)
LAUNCHES = {"fused_adc": 0, "fused_adc4": 0}


class AdcLayout(NamedTuple):
    """One launch of ``rt_fused_adc``: queries a block, LUTs read from
    global memory or not, candidate keys a list, corpus splits, the
    global-memory scratch in keys (0: none) for the pass-1 lists and the
    pass-2 merge, which kernel runs pass 1 (the gather kernel, the word
    kernel, else B5's one-hot MMA kernel), and the word kernel's warps a
    query group (each with its own lists: ``parts`` partial lists a query
    reach pass 2)."""
    bq: int
    lutg: bool
    cap: int
    splits: int
    gbuf_keys: int
    mbuf_keys: int
    gather: bool = False
    word: bool = False
    subsets: int = 1

    @property
    def mode(self) -> int:
        """``rt_fused_adc``'s mode: bit 0 the LUTs in global memory, bit 1
        the gather kernel (B5 needs it; B4 runs it wherever bit 2 is
        clear), bit 2 B4 on the word kernel."""
        return int(self.lutg) | 2 * int(self.gather) | 4 * int(self.word)

    @property
    def parts(self) -> int:
        """Partial lists a query that pass 2 merges."""
        return self.splits * self.subsets

    @property
    def tile(self) -> int:
        """Code rows of one pass-1 tile."""
        return (W_BM if self.word else tile_rows(self.bq) if self.gather
                else A4_BM)


def tile_rows(bq: int) -> int:
    """Code rows of a gather-kernel tile: min(bq, 4) query groups of 256 /
    min(bq, 4) row lanes, 4 rows each."""
    return _fused.NT // min(bq, 4) * 4


def adc_cap(k: int, bq: int) -> int:
    """Candidate keys a query of the gather kernel: k kept keys, one insert
    round (one row per row lane) and about k more."""
    return _fused._pow2(2 * k + _fused.NT // min(bq, 4))


def smem_bytes(bq: int, cap: int, code_bytes: int, kbits: int,
               gbuf: bool = False, lutg: bool = False) -> int:
    """Shared memory of one gather-kernel block (``split_smem_bytes`` in
    the CUDA source): candidate buffers (unless in global memory) and
    thresholds, the block's LUTs over the subspaces the staged code words
    hold (unless read from global memory), the code tile, counters."""
    s_pad = -(-code_bytes // 4) * (32 // kbits)
    return ((0 if gbuf else bq * cap * 8) + bq * 8
            + (0 if lutg else s_pad * bq * (1 << kbits))
            + tile_rows(bq) * (_DKC + 1) * 4 + bq * 8)


def _gather_modes(q: int):
    """The gather kernel's layouts in order of preference (its C entry
    instantiates these only): at most 4 queries, one a block per query
    tile of 1, 2 or 4 with the LUTs in shared memory, then the buffers in
    global memory; then (and for B5's rows too wide for its MMA kernel) 4
    queries a block with the LUTs in global memory."""
    if q <= 4:
        for gbuf in (False, True):
            for bq in (b for b in (1, 2, 4) if b >= q):
                yield bq, gbuf, False
    yield 4, False, True
    yield 4, True, True


def w_chunks(code_bytes: int) -> int:
    """Chunks of 32 subspaces of a B4 code row (the word kernel's stages)."""
    return -(-code_bytes // W_CW)


def w_smem_bytes(bq: int, subsets: int, cap: int, code_bytes: int,
                 gbuf: bool = False, lutg: bool = False) -> int:
    """Shared memory of one word-kernel block (``w_smem_bytes`` in the CUDA
    source): the ring of W_STAGES stages of W_BM rows, the LUTs of its
    bq / 4 query groups unless read from global memory, the ring's
    mbarriers, and its lists (bq * subsets of ``cap`` keys) unless in
    global memory."""
    return (W_STAGES * W_BM * W_CW
            + (0 if lutg else bq // 4 * w_chunks(code_bytes) * W_CHUNK_BYTES)
            + 2 * W_STAGES * 8 + (0 if gbuf else bq * subsets * cap * 8))


def w_blocks_per_sm(bq: int, subsets: int, cap: int, code_bytes: int,
                    gbuf: bool = False, lutg: bool = False) -> int:
    """Resident word-kernel blocks an SM: as many as shared memory allows
    (each block also takes 1 KB), up to what the launch bounds hold
    registers for (two blocks of 9 warps: 18 warps an SM)."""
    fit = SM_SMEM // (w_smem_bytes(bq, subsets, cap, code_bytes, gbuf, lutg)
                      + 1024)
    return max(1, min(fit, 18 // (bq // 4 * subsets + 1)))


def w_query_layout(k: int, code_bytes: int, bq: int | None = None):
    """(queries a block, warps a query group, lists in global memory, LUTs
    in global memory) of the word kernel: among the tiles of ``W_TILES``
    (those of ``bq`` queries, where the caller fixes it) that the ring can
    serve (a warp's next stage at most ``W_STAGES`` steps ahead) and
    shared memory holds, the most resident consumer warps an SM up to
    ``W_ENOUGH_WARPS``, then lists in shared memory, then the wider query
    tile (fewer reads of the codes through L2); the LUTs in global memory
    only where no group's LUTs fit (past M = 192)."""
    cap, nch = _fused.i8_cap(k), w_chunks(code_bytes)
    tiles = [(b, t) for b, t in W_TILES if bq is None or b == bq]
    for lutg in (False, True):
        best = None
        for gbuf in (False, True):
            for b, t in tiles:
                if ((t - 1) * nch >= W_STAGES
                        or w_smem_bytes(b, t, cap, code_bytes, gbuf,
                                        lutg) > SMEM_MAX):
                    continue
                warps = b // 4 * t * w_blocks_per_sm(b, t, cap, code_bytes,
                                                     gbuf, lutg)
                key = (min(warps, W_ENOUGH_WARPS), not gbuf, b)
                if best is None or key > best[0]:
                    best = key, (b, t, gbuf, lutg)
        if best is not None:
            return best[1]
    raise ValueError(f"fused_adc: layout bq={bq} is no word-kernel block "
                     f"(one of {sorted({b for b, _ in W_TILES})})")


def a4_qrow(mb: int) -> int:
    """Bytes of one query's resident B5 LUT row: 32 a code byte (the 16
    even then the 16 odd codewords' entries), zero past mb to a multiple of
    16 code bytes, and a 16-byte pad."""
    return 32 * -(-mb // 16) * 16 + 16


def a4_smem_bytes(bq: int, cap: int, gbuf: bool, mb: int) -> int:
    """Shared memory of one B5 pass-1 block (``a4_smem_bytes`` in the CUDA
    source): the ring of 32-row tiles and its mbarriers, the block's LUTs,
    thresholds, the lists unless in global memory, counts, flags."""
    return (A4_STAGES * (A4_BM * A4_SROW + 16) + bq * a4_qrow(mb) + bq * 8
            + (0 if gbuf else bq * cap * 8) + bq * 8)


def a4_query_tile(q: int) -> int:
    """Queries per B5 block that the batch asks for (``WN`` warps of one n8
    tile in the CUDA source): 32 (4 warps), 16 for batches of at most 16,
    8 for at most 8 (one warp)."""
    return 8 if q <= 8 else 16 if q <= 16 else 32


def a4_blocks_per_sm(bq: int, cap: int, gbuf: bool, mb: int) -> int:
    """Resident B5 blocks an SM: as many as shared memory allows (each
    block also takes 1 KB), up to the launch bounds' count (two blocks of
    32 queries, four of fewer)."""
    fit = SM_SMEM // (a4_smem_bytes(bq, cap, gbuf, mb) + 1024)
    return max(1, min(fit, 2 if bq == 32 else 4))


def a4_query_layout(q: int, k: int, mb: int):
    """(queries per B5 block, lists in global memory), or None where even 8
    queries' LUTs do not fit in shared memory (past mb = 864 code bytes):
    those rows take the gather kernel with LUTs read from global memory.
    The batch's tile with its lists in shared memory where they fit, else
    in global memory; where a 32-query block would sit alone on its SM
    (lists of 512 keys), blocks of 8 queries, four an SM, as B2 int8."""
    cap = _fused.i8_cap(k)
    tile = a4_query_tile(q)
    if (tile == 32 and a4_smem_bytes(32, cap, False, mb) <= SMEM_MAX
            and a4_blocks_per_sm(32, cap, False, mb) < 2):
        tile = 8
    for bq in dict.fromkeys((tile, 8)):
        for gbuf in (False, True):
            if a4_smem_bytes(bq, cap, gbuf, mb) <= SMEM_MAX:
                return bq, gbuf
    return None


#: query rows a block holds, by kernel (the instances ``rt_fused_adc``
#: launches): the gather kernel's 1, 2 or 4, the word kernel's ``W_TILES``,
#: B5's MMA kernel's 1, 2 or 4 warps of 8 queries
GATHER_BQ = (1, 2, 4)
WORD_BQ = tuple(sorted({b for b, _ in W_TILES}))
A4_BQ = (8, 16, 32)


def block_rows(kbits: int, q: int) -> tuple[int, ...]:
    """The query rows a block can hold for a batch of q: the gather
    kernel's up to 4 queries, else the word kernel's (B4) or the MMA
    kernel's and, for rows too wide for it, the gather kernel's 4 (B5)."""
    if q <= 4:
        return GATHER_BQ
    return WORD_BQ if kbits == 8 else (4, *A4_BQ)


def adc_layout(k: int, code_bytes: int, kbits: int, q: int, n: int,
               bq: int | None = None, bn: int | None = None) -> AdcLayout:
    """The whole launch layout of one fused ADC scan; the wrapper's one
    place that decides it (the CUDA source takes it as arguments).  From 5
    queries on, B4 runs the word kernel (``w_query_layout``) and B5 the
    one-hot MMA kernel at every width where 8 queries' LUTs fit in shared
    memory.  Batches of at most 4 queries take the gather kernel at 1, 2
    or 4 queries a block (a word of 4 queries or an MMA tile of 8 would
    waste most of its work), as do B5's rows past that width (4 queries a
    block, LUTs read from global memory).

    ``bq`` (query rows a block) and ``bn`` (corpus rows a split) override
    the choice within that kernel: a tuning table's entry (the splits
    keep the layout's k cap, ``_fused.split_count``).  An override the
    CUDA source would refuse raises ``ValueError``."""
    if bq is not None and bq not in block_rows(kbits, q):
        raise ValueError(f"fused_adc: layout bq={bq} is no block for "
                         f"{q} queries (one of {block_rows(kbits, q)})")
    mbuf = 0 if _fused.merge_in_shared(k) else q * _fused._pow2(k + _fused.NT)

    def wave(per_sm: int, qblocks: int, tile: int) -> int:
        # one wave: as many blocks as are resident at once
        if bn is not None:
            return _fused.split_count(n, bn, tile, k)
        return max(1, min(per_sm * _fused._SMS // qblocks,
                          -(-n // max(_fused._MIN_SPLIT_ROWS, 2 * k)), 65535))

    if kbits == 8 and q > 4:
        bq, t, gbuf, lutg = w_query_layout(k, code_bytes, bq)
        cap = _fused.i8_cap(k)
        qblocks = -(-q // bq)
        splits = wave(w_blocks_per_sm(bq, t, cap, code_bytes, gbuf, lutg),
                      qblocks, W_BM)
        return AdcLayout(bq, lutg, cap, splits,
                         qblocks * splits * bq * t * cap if gbuf else 0, mbuf,
                         word=True, subsets=t)
    a4 = a4_query_layout(q, k, code_bytes) if kbits == 4 and q > 4 else None
    if a4 is not None and bq != 4:
        cap = _fused.i8_cap(k)
        if bq is None:
            bq, gbuf = a4
        else:
            gbuf = _fused._fixed_block(
                bq, A4_BQ, lambda g: a4_smem_bytes(bq, cap, g, code_bytes))
        qblocks = -(-q // bq)
        splits = wave(a4_blocks_per_sm(bq, cap, gbuf, code_bytes), qblocks,
                      A4_BM)
        return AdcLayout(bq, False, cap, splits,
                         qblocks * splits * bq * cap if gbuf else 0, mbuf)
    if kbits == 4 and q > 4 and bq not in (None, 4):
        raise ValueError(f"fused_adc: layout bq={bq}: rows of {code_bytes} "
                         "bytes take the gather kernel (bq 4)")
    modes = (list(_gather_modes(q)) if bq is None else
             [(bq, g, False) for g in (False, True) if q <= 4]
             + ([(4, False, True), (4, True, True)] if bq == 4 else []))
    for b, gbuf, lutg in modes:
        cap = adc_cap(k, b)
        if smem_bytes(b, cap, code_bytes, kbits, gbuf, lutg) <= SMEM_MAX:
            break
    else:
        raise ValueError(f"fused_adc: layout bq={bq}: no gather-kernel "
                         f"block of {bq} queries fits rows of {code_bytes} "
                         "bytes in shared memory")
    bq = b
    splits = (n_splits(q, n, bq, k) if bn is None
              else _fused.split_count(n, bn, tile_rows(bq), k))
    return AdcLayout(bq, lutg, cap, splits,
                     -(-q // bq) * splits * bq * cap if gbuf else 0, mbuf,
                     gather=True)


def query_tile(k: int, code_bytes: int, kbits: int, q: int) -> int:
    """Query rows per block of a batch of q (``adc_layout``'s choice)."""
    return adc_layout(k, code_bytes, kbits, q, 1).bq


def n_splits(q: int, n: int, bq: int, k: int = 1) -> int:
    """Corpus ranges the gather kernel's pass 1 splits the scan into
    (blocks along y): 528 blocks, at least 2048 and 2k rows a split."""
    return _fused._split_count(-(-q // bq), n, k, _fused._TARGET_BLOCKS)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def fused_adc_plain(lut2d, codes, *, k: int, n_codewords: int, mask=None):
    """Plain B4: [Q, M*K] int8 LUT x [N, M] uint8 codes -> top-k, summing
    one subspace at a time into a [Q, N] int32 accumulator."""
    Q = lut2d.shape[0]
    m = codes.shape[1]
    lut = lut2d.reshape(Q, m, n_codewords)
    s = torch.zeros((Q, codes.shape[0]), dtype=torch.int32, device=codes.device)
    for j in range(m):
        s += lut[:, j].index_select(1, codes[:, j].long())
    return _fused._masked_topk(s, k, mask)


def fused_adc4_plain(lut_even, lut_odd, packed, *, k: int, mask=None):
    """Plain B5: [Q, (M/2)*16] int8 LUT halves x [N, M/2] packed uint8
    nibbles (low = even subspace) -> top-k, subspace by subspace."""
    Q, mb = lut_even.shape[0], packed.shape[1]
    le = lut_even.reshape(Q, mb, 16)
    lo = lut_odd.reshape(Q, mb, 16)
    s = torch.zeros((Q, packed.shape[0]), dtype=torch.int32,
                    device=packed.device)
    for j in range(mb):
        col = packed[:, j]
        s += le[:, j].index_select(1, (col & 0x0F).long())
        s += lo[:, j].index_select(1, (col >> 4).long())
    return _fused._masked_topk(s, k, mask)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_adc: {msg}")


def _launch(name: str, kbits: int, lut0, lut1, codes, mask, k: int,
            bq: int | None, bn: int | None):
    dev = codes.device
    Q, N, mb = lut0.shape[0], codes.shape[0], codes.shape[1]
    _check(1 <= k <= N, f"k={k} outside [1, N={N}]")
    _check(N < 2 ** 31, "row ids are int32")
    _check(codes.dtype == torch.uint8, f"codes must be uint8, got {codes.dtype}")
    for t in (lut0, lut1, codes, mask):
        _check(t is None or (t.device == dev and t.is_contiguous()),
               "every tensor must be contiguous and on the codes' device")
    for t in (lut0, lut1):
        _check(t is None or (t.dtype == torch.int8 and t.dim() == 2
                             and t.shape == (Q, mb * (1 << kbits))),
               f"LUT must be int8 [{Q}, {mb * (1 << kbits)}], got "
               f"{None if t is None else (t.dtype, tuple(t.shape))}")
    if mask is not None:
        _check(mask.shape == (N,), f"mask must be [{N}], got {tuple(mask.shape)}")
        mask = mask.to(torch.int8)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    lay = adc_layout(k, mb, kbits, Q, N, bq, bn)
    part = torch.empty(Q * lay.parts * k, dtype=torch.int64, device=dev)
    gbuf = (torch.empty(lay.gbuf_keys, dtype=torch.int64, device=dev)
            if lay.gbuf_keys else None)
    mbuf = (torch.empty(lay.mbuf_keys, dtype=torch.int64, device=dev)
            if lay.mbuf_keys else None)
    rc = _build.lib("adc").rt_fused_adc(
        kbits, lay.bq, lay.mode, lay.subsets, lay.cap, lut0.data_ptr(),
        None if lut1 is None else lut1.data_ptr(), codes.data_ptr(),
        None if mask is None else mask.data_ptr(), part.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(),
        None if mbuf is None else mbuf.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), Q, N, mb, k, lay.splits,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_adc")
    _build.count(LAUNCHES, name)
    return out_s, out_i


def fused_adc_cuda(lut2d: torch.Tensor, codes: torch.Tensor, *, k: int,
                   n_codewords: int = 256, mask: torch.Tensor | None = None,
                   bq: int | None = None, bn: int | None = None):
    """B4: [Q, M*K] int8 LUT x [N, M] uint8 codes -> top-k, streaming.
    ``bq`` / ``bn`` override the launch layout (``adc_layout``); the plain
    version has none."""
    if codes.device.type == "cpu":
        return fused_adc_plain(lut2d, codes, k=k, n_codewords=n_codewords,
                               mask=mask)
    _check(codes.device.type == "cuda", f"unsupported device {codes.device}")
    _check(n_codewords == 256, "the B4 kernels take 256-codeword codebooks "
           f"(16 codewords go packed through B5), got {n_codewords}")
    return _launch("fused_adc", 8, lut2d, None, codes, mask, k, bq, bn)


def fused_adc4_cuda(lut_even: torch.Tensor, lut_odd: torch.Tensor,
                    packed: torch.Tensor, *, k: int,
                    mask: torch.Tensor | None = None, bq: int | None = None,
                    bn: int | None = None):
    """B5: [Q, (M/2)*16] int8 LUT halves x [N, M/2] packed codes -> top-k,
    with B4's layout overrides."""
    if packed.device.type == "cpu":
        return fused_adc4_plain(lut_even, lut_odd, packed, k=k, mask=mask)
    _check(packed.device.type == "cuda", f"unsupported device {packed.device}")
    return _launch("fused_adc4", 4, lut_even, lut_odd, packed, mask, k, bq,
                   bn)

"""The scoring engine's query hot path (port of the main-path half of
``repro.engine.scorer``).

``topk`` / ``topk_among`` / ``make_score_set`` / ``make_batch_score_set``
own metric x bits dispatch, chunking, invalid-id masking and streaming
top-k; index classes hold structure and delegate every score here.
``refine_among`` (a cascade stage) and ``topk_among_regional`` (per-region
Eq. 1 constants, dequantized rows) are candidate top-k in plain torch,
as in the reference, where no TPU kernel takes them either.

Dispatch (metric x storage), by the store's device:

    storage          ip / l2 on CUDA        ip / l2 on CPU    angular
    fp32             B2 fused_topk (f32)    scan              scan
    int8             B2 fused_topk (int8)   scan              scan
    int4 packed      B3 fused_topk4         scan              scan
    PQ, int8 LUT     B4 fused_adc           ADC scan          ValueError
    PQx4, int8 LUT   B5 fused_adc4          ADC scan          ValueError
    PQ, fp32 LUT     ADC scan               ADC scan          ValueError

A CUDA store with metric ip or l2 always runs B2-B5, whatever its size
(the reference's ``store.n > tile`` and backend gate is a TPU-versus-
interpret switch and does not carry over).  A CPU store always runs the
plain scan, whose stats equal the reference's scan branch exactly.  An
fp32-LUT PQ store takes the streaming gather-sum ADC scan on every device,
as in the reference, where no TPU kernel takes it either.  Nothing catches
a kernel failure to fall back to the scan.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import distances as D
from repro_torch.core import pack as PK
from repro_torch.engine.store import CodeStore, PQStore
from repro_torch.kernels import adc as _adc
from repro_torch.kernels import fused_topk as _fused
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import NEG, stable_desc

ScoreSet = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# generic streaming machinery
# --------------------------------------------------------------------------

def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two [Q, ka]/[Q, kb] candidate sets into the best k (stable:
    on equal scores the earlier set, then the earlier column, wins)."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    pos = stable_desc(s, k)
    return torch.gather(s, -1, pos), torch.gather(i, -1, pos)


def pad_rows(a: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Zero-pad rows to a multiple; engine paths id-mask the pad rows."""
    n = a.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return a, n
    return torch.nn.functional.pad(a, (0, 0, 0, target - n)), n


def remap_ids(ids: torch.Tensor, id_map: torch.Tensor) -> torch.Tensor:
    """Gather ``id_map[ids]`` with -1 (no hit) passed through."""
    safe = torch.clamp(ids, 0, id_map.shape[0] - 1).long()
    return torch.where(ids >= 0, id_map[safe].to(torch.int32), -1)


def _stream_topk(q, data, k, chunk, n_valid, tile_scores, mask=None):
    """THE streaming top-k loop: scores ``data`` in ``chunk``-row tiles
    through ``tile_scores(q, tile)`` with a running [Q, k] best set
    (``merge_topk``), id-masking rows >= ``n_valid`` and rows whose
    optional [n] ``mask`` is False at the source."""
    Q = q.shape[0]
    dev = data.device
    best_s = torch.full((Q, k), NEG, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    allowed = None if mask is None else mask.to(device=dev, dtype=torch.bool)
    for start in range(0, max(data.shape[0], 1), chunk):
        tile = data[start:start + chunk]
        s = tile_scores(q, tile).to(torch.float32)
        gid = torch.arange(start, start + tile.shape[0], dtype=torch.int32,
                           device=dev)[None, :]
        ok = gid < n_valid
        if allowed is not None:
            ok = ok & allowed[start:start + tile.shape[0]][None, :]
        s = torch.where(ok, s, NEG)
        ids = torch.where(ok, gid.expand_as(s), -1)
        best_s, best_i = merge_topk(best_s, best_i, s, ids, k)
    return best_s, best_i


def chunked_topk(queries, corpus, k: int, score_fn, chunk: int = 16384,
                 n_valid: int | None = None, mask=None):
    """Exact top-k of ``score_fn(queries, corpus)`` without materializing
    [Q, N]: the generic score-fn entry over ``_stream_topk``."""
    n_valid = corpus.shape[0] if n_valid is None else n_valid

    def tile_scores(q, tile):
        return score_fn(q, tile).to(torch.float32)

    return _stream_topk(queries, corpus, k, chunk, n_valid, tile_scores,
                        mask=mask)


# --------------------------------------------------------------------------
# stats: uniform per-search accounting for SearchResult.stats
# --------------------------------------------------------------------------

def search_stats(store, *, candidates: int, chunks: int,
                 rows_read: int) -> dict[str, Any]:
    """The uniform accounting block every kind reports (candidates per
    query, corpus tiles touched, payload bytes for the whole batch)."""
    return {
        "candidates": int(candidates),
        "chunks": int(chunks),
        "bytes_read": int(rows_read) * store.row_bytes,
        "bits": int(getattr(store, "bits", 8)),
        "packed": bool(getattr(store, "packed", False)),
    }


def make_score_set(store: CodeStore, metric: str) -> ScoreSet:
    """(query [d], ids [m]) -> larger-is-closer [m] f32 over store rows."""

    def score_set(q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        vecs = store.take(ids)
        return D.scores(q[None], vecs, metric,
                        quantized=store.quantized)[0].to(torch.float32)

    return score_set


def make_batch_score_set(store: CodeStore, metric: str) -> ScoreSet:
    """(queries [Q, d], ids [Q, W]) -> larger-is-closer [Q, W] f32 over
    store rows: the batched graph walk's score set.  Integer scores are
    summed exactly and cast to f32 afterwards, as ``make_score_set``'s."""

    def score_set(q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        rows = store.take(ids)                             # [Q, W, d]
        return D.scores_among(q, rows, metric,
                              quantized=store.quantized).to(torch.float32)

    return score_set


# --------------------------------------------------------------------------
# full-corpus top-k
# --------------------------------------------------------------------------

def _scan_topk(q, store: CodeStore, k: int, metric: str, chunk: int,
               mask=None):
    """The plain scan: ``_stream_topk`` over the store's tiles, unpacking
    int4 chunk by chunk (the full-width corpus never materializes)."""

    def tile_scores(qq, tile):
        rows = PK.unpack_int4(tile) if store.packed else tile
        return D.scores(qq, rows, metric, quantized=store.quantized)

    return _stream_topk(q, store.data, k, chunk, store.n, tile_scores,
                        mask=mask)


def topk(queries, store: CodeStore | PQStore, k: int, metric: str, *,
         chunk: int = 16384, prepared: bool = False, mask=None):
    """Exact top-k of the whole store: (scores [Q, k] f32, ids, stats).

    When k > n the tail is padded with (NEG, -1).  ``prepared=True`` means
    ``queries`` are already in the store's code space (a ``PQStore`` takes
    raw queries either way: its LUT is their code space).  ``chunk`` sizes
    the scan's chunks.  An optional [n] ``mask`` (True = allowed) rides the
    id-masking fence on every path.  ``stats["tuned"]`` is always False:
    the tuning tables are not ported.
    """
    if isinstance(store, PQStore):
        return _topk_pq_stats(queries, store, k, metric, chunk, mask)
    q = (queries.to(store.device) if prepared
         else store.encode_queries(queries))
    k_eff = min(k, store.n)
    if store.device.type == "cuda" and metric in ("ip", "l2"):
        s, i = K.fused_topk(q, store.data, k_eff, metric,
                            packed=store.packed, mask=mask)
        chunks = -(-store.n // (_fused.BN if q.dtype == torch.float32
                                else _fused.I8_BM))
        # pass 1 re-streams the corpus once per query block
        bq = K.fused_query_tile(k_eff, q.shape[0],
                                fp32=q.dtype == torch.float32)
        passes = max(1, -(-q.shape[0] // bq))
    else:
        s, i = _scan_topk(q, store, k_eff, metric, chunk, mask)
        chunks = max(1, -(-store.n // chunk))
        passes = 1                       # one scan, all queries resident

    if k_eff < k:                        # uniform [Q, k] contract: -1 pads
        s = torch.nn.functional.pad(s, (0, k - k_eff), value=NEG)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    if store.base:
        i = torch.where(i >= 0, i + store.base, -1)
    stats = search_stats(store, candidates=store.n, chunks=chunks,
                         rows_read=store.n * passes)
    stats["tuned"] = False
    return s, i, stats


# --------------------------------------------------------------------------
# PQ: ADC — fused kernel (B4 / B5) or streaming LUT gather-sum scan
# --------------------------------------------------------------------------

def build_pq_lut(queries, store: PQStore, metric: str) -> torch.Tensor:
    """Per-query ADC lookup table [Q, M, K] f32 of query-to-codeword
    scores (K = ``store.n_codewords``): ip, or negated squared L2.

    The d/M terms of each entry are summed one elementwise step at a time,
    in dimension order, so a query's table is the same bits whatever batch
    it rides in (a padded Searcher bucket or a one-shot call): a batched
    GEMM may block, and so round, differently as the batch's row count
    changes.  Full fp32 on every device."""
    q = queries.to(device=store.device, dtype=torch.float32)
    Q, d = q.shape
    qs = q.reshape(Q, store.m, d // store.m)
    acc = None
    for t in range(qs.shape[2]):
        qt = qs[:, :, t, None]                          # [Q, M, 1]
        ct = store.codebooks[None, :, :, t]             # [1, M, K]
        term = qt * ct if metric == "ip" else (qt - ct) * (qt - ct)
        acc = term if acc is None else acc + term
    return acc if metric == "ip" else -acc


def quantize_pq_lut(lut: torch.Tensor) -> torch.Tensor:
    """The paper's after-the-codebook composition (``lpq_tables``): Eq. 1
    abs-max quantization of the LUT entries to int8, one scale **per
    query** (over that query's [M, K] table), in the reference's operation
    order: divide by the abs-max, times 127, round half to even, clip.
    Per-query scaling keeps a query's quantized LUT independent of batch
    composition: a Searcher pad row (whose negated-L2 table is large)
    cannot move a real query's scale."""
    amax = torch.clamp_min(torch.amax(torch.abs(lut), dim=(1, 2),
                                      keepdim=True), 1e-12)
    return torch.clamp(torch.round(lut / amax * 127.0), -128,
                       127).to(torch.int8)


def _prepare_pq_lut(queries, store: PQStore, metric: str) -> torch.Tensor:
    """The per-batch ADC table build: ``build_pq_lut`` plus — for
    ``lpq_tables`` stores — the Eq. 1 int8 quantization.  The one function
    both the one-shot and the Searcher path build their tables through."""
    lut = build_pq_lut(queries, store, metric)
    return quantize_pq_lut(lut) if store.lpq_tables else lut


def _pq_fused(store: PQStore, metric: str) -> bool:
    """B4 / B5 take a CUDA store with int8 LUTs and metric ip or l2; every
    other PQ store takes the streaming gather-sum scan."""
    return (store.device.type == "cuda" and store.lpq_tables
            and metric in ("ip", "l2"))


def _topk_pq(queries, store: PQStore, k: int, metric: str, chunk: int,
             mask=None):
    """Asymmetric distance computation over the code matrix: the per-query
    LUT, then ``_topk_pq_from_lut``."""
    lut = _prepare_pq_lut(queries, store, metric)
    return _topk_pq_from_lut(lut, store, k, metric, chunk, mask=mask)


def _topk_pq_from_lut(lut, store: PQStore, k: int, metric: str, chunk: int,
                      mask=None):
    """Top-k of the whole code matrix given the [Q, M, K] LUT: the fused
    kernel (``_pq_fused``: int8 LUT resident in shared memory, 4-bit codes
    split in registers, int32 sums, running top-k — the [Q, N] ADC matrix
    never exists) or the streaming scan (``_stream_topk`` over code chunks
    with a gather-sum tile, unpacking 4-bit codes chunk by chunk).  Both
    give the same result, bit for bit, on an int8 LUT."""
    n = store.n
    k_eff = min(k, n)
    if _pq_fused(store, metric):
        return K.fused_adc_topk(lut, store.codes, k_eff, packed=store.packed,
                                mask=mask)
    ilut = lut.to(torch.int32) if store.lpq_tables else lut

    def tile_scores(lt, tile_codes):                    # [c, Mb] -> [Q, c]
        rows = (PK.unpack_uint4(tile_codes)[:, : store.m]
                if store.packed else tile_codes)
        idx = rows.T[None].to(torch.int64)              # [1, M, c]
        return torch.sum(torch.take_along_dim(lt, idx, dim=2), dim=1,
                         dtype=lt.dtype).to(torch.float32)

    return _stream_topk(ilut, store.codes, k_eff, chunk, n, tile_scores,
                        mask=mask)


def _topk_pq_stats(queries, store: PQStore, k: int, metric: str, chunk: int,
                   mask=None):
    """``topk``'s PQStore branch: (scores, ids, stats) padded to [Q, k]."""
    if metric == "angular":
        raise ValueError(
            "PQ/ADC scoring supports ip and l2 only (see the dispatch "
            "table in this module's docstring)"
        )
    Q = queries.shape[0]
    s, i = _topk_pq(queries, store, k, metric, chunk, mask=mask)
    if s.shape[1] < k:                   # uniform [Q, k] contract: -1 pads
        s = torch.nn.functional.pad(s, (0, k - s.shape[1]), value=NEG)
        i = torch.nn.functional.pad(i, (0, k - i.shape[1]), value=-1)
    if _pq_fused(store, metric):
        lay = _adc.adc_layout(min(k, store.n), store.row_bytes, store.bits, Q,
                              store.n)
        n_chunks = -(-store.n // lay.tile)
        # the fused grid re-streams the code matrix once per query block
        # (the LUTs are what stay resident, not the codes)
        passes = max(1, -(-Q // lay.bq))
    else:
        n_chunks = max(1, -(-store.n // chunk))
        passes = 1
    stats = search_stats(store, candidates=store.n, chunks=n_chunks,
                         rows_read=store.n * passes)
    stats["tuned"] = False
    return s, i, stats


# --------------------------------------------------------------------------
# candidate-set top-k and the rerank tail
# --------------------------------------------------------------------------

def topk_among(q_codes, store: CodeStore, cand_ids, k: int, metric: str,
               mask=None):
    """Top-k restricted to per-query candidate lists.

    q_codes [Q, d_eff] prepared queries; cand_ids [Q, L] (-1 = empty
    slot).  Gathers store rows (unpacking int4 only for what was gathered),
    scores them batched (``D.scores_among``), masks empties, returns
    ([Q, k], [Q, k]); ties go to the earlier candidate slot.
    """
    L = cand_ids.shape[1]
    k_eff = min(k, L)
    cand_ids = cand_ids.to(store.device)
    ok = cand_ids >= 0
    safe = torch.where(ok, cand_ids, 0).long()
    if mask is not None:
        ok = ok & mask.to(device=store.device, dtype=torch.bool)[safe]
    rows = store.take(safe)                              # [Q, L, d]
    s = D.scores_among(q_codes, rows, metric, quantized=store.quantized)
    s = torch.where(ok, s.to(torch.float32), NEG)
    pos = stable_desc(s, k_eff)
    s = torch.gather(s, 1, pos)
    i = torch.where(s > NEG, torch.gather(cand_ids, 1, pos),
                    -1).to(torch.int32)
    if k_eff < k:
        s = torch.nn.functional.pad(s, (0, k - k_eff), value=NEG)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    if store.base:
        i = torch.where(i >= 0, i + store.base, -1)
    return s, i


def rerank_among(queries, store: CodeStore, cand_ids, k: int, metric: str,
                 mask=None):
    """Re-score candidate ids against a higher-precision store (the
    Searcher's rerank tail).  Returns (scores, ids, stats delta)."""
    q = store.encode_queries(queries)
    s, i = topk_among(q, store, cand_ids, k, metric, mask)
    depth = int(cand_ids.shape[1])
    stats = {
        "reranked": depth,
        "rerank_bits": int(store.bits),
        "rerank_bytes": int(cand_ids.shape[0]) * depth * store.row_bytes,
    }
    return s, i, stats


# --------------------------------------------------------------------------
# cascade stages: budgeted refinement and per-region constant lookup
# --------------------------------------------------------------------------

def refine_among(queries, store: CodeStore, cand_ids, out_k: int,
                 metric: str, mask=None):
    """One cascade refinement stage: re-score the surviving candidates at
    this store's precision and keep the best ``out_k``.

    The rerank tail's body (``topk_among``), so a cascade's final fp32
    stage equals the ``+r32`` tail at the same depth; the stats are the
    stage's: ``candidates`` (the incoming list width), the gathered
    payload ``bytes_read`` and the code width ``bits``."""
    q = store.encode_queries(queries)
    s, i = topk_among(q, store, cand_ids, out_k, metric, mask)
    depth = int(cand_ids.shape[1])
    stats = {
        "candidates": depth,
        "bytes_read": int(cand_ids.shape[0]) * depth * store.row_bytes,
        "bits": int(store.bits),
    }
    return s, i, stats


def topk_among_regional(queries, store: CodeStore, region_scale, region_zero,
                        assign, cand_ids, k: int, metric: str, mask=None):
    """Candidate top-k with per-region Eq. 1 constant lookup.

    Codes quantized under different regions' constants are not comparable
    as integers, so fp32 ``queries`` score *dequantized* rows: each
    gathered candidate's region (``assign`` [N]) picks its own
    ``region_scale`` / ``region_zero`` rows ([R, d]), and the code maps
    back to fp32 as ``codes * scale + zero`` (a product, then a sum, as
    the reference) before the metric.  Empty slots, the optional row
    ``mask``, the (NEG, -1) pads, ``base`` rebasing and the slot-order tie
    break are ``topk_among``'s."""
    L = cand_ids.shape[1]
    k_eff = min(k, L)
    dev = store.device
    cand_ids = cand_ids.to(dev)
    ok = cand_ids >= 0
    safe = torch.where(ok, cand_ids, 0).long()
    if mask is not None:
        ok = ok & mask.to(device=dev, dtype=torch.bool)[safe]
    reg = assign[safe].long()                            # [Q, L]
    x = store.take(safe).to(torch.float32)               # [Q, L, d]
    x.mul_(region_scale[reg])
    x.add_(region_zero[reg])
    q = queries.to(device=dev, dtype=torch.float32)
    s = D.scores_among(q, x, metric, quantized=False)
    del x
    s = torch.where(ok, s.to(torch.float32), NEG)
    pos = stable_desc(s, k_eff)
    s = torch.gather(s, 1, pos)
    i = torch.where(s > NEG, torch.gather(cand_ids, 1, pos),
                    -1).to(torch.int32)
    if k_eff < k:
        s = torch.nn.functional.pad(s, (0, k - k_eff), value=NEG)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    if store.base:
        i = torch.where(i >= 0, i + store.base, -1)
    return s, i


#: bytes one element of a regional gather holds at its peak: the int8
#: code, its fp32 copy, the gathered scale and zero, and the metric's
#: fp32 temporary (``topk_among_regional``)
REGIONAL_ELT_BYTES = 1 + 4 * 4


def regional_stats(store: CodeStore, cand_ids) -> dict[str, Any]:
    """Stats delta of one ``topk_among_regional`` call: the gathered code
    payload plus the per-row constant lookup (scale + zero, fp32 [d])."""
    depth = int(cand_ids.shape[1])
    const_bytes = 2 * 4 * int(store.d)
    return {
        "candidates": depth,
        "bytes_read": int(cand_ids.shape[0]) * depth * (store.row_bytes
                                                         + const_bytes),
        "bits": int(store.bits),
        "packed": bool(store.packed),
        "regional": True,
    }

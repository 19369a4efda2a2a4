"""The measured autotuner: time the surviving candidates on the live
device, hold every one bit-equal to the plain version, emit a
``TuneTable`` (port of ``repro.tune.autotuner``).

Per workload:

    1. build a deterministic store from the runtime profile's seed (numpy
       derives one seed a workload, a ``torch.Generator`` on the device
       draws the data: same device + seed => same data),
    2. enumerate the family's legal candidates (:mod:`repro_torch.tune.space`)
       and prune them with the roofline model,
    3. for each survivor: run it once, hold it **bit-equal** to the oracle
       score matrix (``kernels.ref``; a candidate that cannot reproduce
       the oracle's top-k scores exactly is a bug, not a slow config: the
       tuner raises), then time it (warm-up + median),
    4. pick with hysteresis: keep the default-dispatch config unless a
       candidate beats it by more than ``margin``, so noise cannot flap
       the table between equivalent configs,
    5. record the choice (with its measured and default medians) under the
       workload's bucket key.

Parity is tie-robust (the reference's rule): the candidate's top-k
*scores* must equal the stable top-k of the full oracle matrix, and every
returned id must point at a row whose oracle score equals the returned
score, and no row may be returned twice in one result (a tile two splits
scanned would otherwise pass wherever its score ties another row's).

``timer`` is injectable: ``wall_timer`` times on the device (CUDA events
on the card), ``estimate_timer`` stands the roofline estimate in for it,
so the determinism tests build a table that is a pure function of
(backend, seed); parity always runs on the real executions.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import scorer
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.runtime import profile as rtprofile
from repro_torch.tune import space as S
from repro_torch.tune.table import TuneConfig, TuneTable, live_stamp

#: vector width of an ADC workload's fixture (the main path's product
#: width), rounded up to a multiple of the workload's M
ADC_WIDTH = 256
#: oracle working set a block of corpus rows may take (bytes)
ORACLE_BYTES = 1 << 29


def default_workloads(smoke: bool = False) -> tuple[S.Workload, ...]:
    """The shapes a ``python -m repro_torch.tune`` run measures.

    Smoke keeps every corpus small (the parity check is the point there)
    and gives the scan family an awkward ``n`` (20480: not a multiple of
    the 16384 default chunk, so the default scan pads to 32768 rows).  The
    full run measures the main path's widths at its 4,000,000-row bucket,
    a 256-query Searcher bucket and k=100: B2 int8 ip at d=256 and l2 at
    d=128, B3 ip at d=256, B4 ``pq32``, B5 ``pq64x4`` and the angular scan
    at d=100."""
    if smoke:
        return (
            S.Workload("fused_topk", "ip", 8, 8, 1536, 32),
            S.Workload("packed", "l2", 4, 8, 1536, 32),
            S.Workload("fused_adc", "ip", 8, 8, 1536, 8),
            S.Workload("scan", "angular", 8, 8, 20480, 32),
        )
    n, q, k = 4_000_000, 256, 100
    return (
        S.Workload("fused_topk", "ip", 8, q, n, 256, k),
        S.Workload("fused_topk", "l2", 8, q, n, 128, k),
        S.Workload("packed", "ip", 4, q, n, 256, k),
        S.Workload("fused_adc", "ip", 8, q, n, 32, k),
        S.Workload("fused_adc", "ip", 4, q, n, 64, k),
        S.Workload("scan", "angular", 8, q, n, 100, k),
    )


def wall_timer(fn: Callable, *, cfg: TuneConfig, workload: S.Workload,
               repeats: int = 3, warmup: int = 1) -> float:
    """Median seconds of ``fn()`` (the default timer): CUDA events around
    each call where its results lie on the card, else the host clock."""
    del cfg, workload
    out = None
    for _ in range(max(1, warmup)):
        out = fn()
    cuda = out[0].is_cuda
    times = []
    for _ in range(repeats):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def estimate_timer(fn: Callable, *, cfg: TuneConfig, workload: S.Workload,
                   repeats: int = 3, warmup: int = 1) -> float:
    """Deterministic fake timer: the roofline estimate stands in for the
    clock (the determinism tests' injection; never the default)."""
    del fn, repeats, warmup
    return S.estimate(workload, cfg)


@dataclasses.dataclass
class _Ctx:
    """One workload's fixtures: the store, prepared queries (or the int8
    ADC LUT), the full oracle score matrix and its stable top-k scores."""

    store: object
    q: Optional[torch.Tensor]
    lut: Optional[torch.Tensor]
    full: torch.Tensor
    top: torch.Tensor


def workload_seed(seed: int, index: int) -> int:
    """The data seed of the ``index``-th workload (the reference's
    ``fold_in``): one numpy ``SeedSequence`` draw."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def _blocks(n: int, row_bytes: int):
    step = max(1, ORACLE_BYTES // max(1, row_bytes))
    return ((s, min(n, s + step)) for s in range(0, n, step))


def _oracle(w: S.Workload, store, qc, lut) -> torch.Tensor:
    """The full [Q, N] f32 oracle score matrix (``kernels.ref``), built in
    blocks of corpus rows."""
    Q, n = w.q, store.n
    full = torch.empty((Q, n), dtype=torch.float32, device=store.device)
    if w.kernel == "fused_adc":
        lt = lut.to(torch.int32)
        if store.packed and lt.shape[1] < 2 * store.codes.shape[1]:
            lt = torch.nn.functional.pad(
                lt, (0, 0, 0, 2 * store.codes.shape[1] - lt.shape[1]))
        oracle = R.adc4_ref if store.packed else R.adc_ref
        for a, b in _blocks(n, Q * lt.shape[1] * 8):
            full[:, a:b] = oracle(lt, store.codes[a:b]).to(torch.float32)
        return full
    from repro_torch.core import distances as D
    from repro_torch.core import pack as PK

    for a, b in _blocks(n, Q * 16):
        x = store.data[a:b]
        if w.metric in ("ip", "l2") and store.quantized:
            if store.packed:
                s = (R.qmip4_ref if w.metric == "ip" else R.ql24_ref)(qc, x)
            else:
                s = (R.qmip_ref if w.metric == "ip" else R.ql2_ref)(qc, x)
        else:
            rows = PK.unpack_int4(x) if store.packed else x
            s = D.scores(qc, rows, w.metric, quantized=store.quantized)
        full[:, a:b] = s.to(torch.float32)
    return full


def _stable_top(full: torch.Tensor, k: int) -> torch.Tensor:
    """Scores of the stable top-k of each row (``ref.topk_ref``), a few
    rows at a time."""
    rows = max(1, (1 << 26) // max(1, full.shape[1]))
    return torch.cat([R.topk_ref(full[a:a + rows], k)[0]
                      for a in range(0, full.shape[0], rows)])


def _build_ctx(w: S.Workload, seed: int, device: torch.device) -> _Ctx:
    from repro_torch.knn import make_index

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    k = min(w.k, w.n)
    if w.kernel == "fused_adc":
        dim = w.d * max(1, -(-ADC_WIDTH // w.d))
        corpus = torch.randn((w.n, dim), generator=g, device=device) * 0.1
        queries = torch.randn((w.q, dim), generator=g, device=device) * 0.1
        spec = f"pq{w.d}x{w.bits}+lpq" if w.bits == 4 else f"pq{w.d}+lpq"
        store = make_index(spec, corpus, metric=w.metric, kmeans_iters=2,
                           key=seed, device=device).store
        del corpus
        lut = scorer._prepare_pq_lut(queries, store, w.metric)
        full = _oracle(w, store, None, lut)
        return _Ctx(store, None, lut, full, _stable_top(full, k))

    spec = {4: "flat,lpq4", 8: "flat,lpq8"}.get(w.bits, "flat")
    corpus = torch.randn((w.n, w.d), generator=g, device=device) * 0.1
    queries = torch.randn((w.q, w.d), generator=g, device=device) * 0.1
    store = make_index(spec, corpus, metric=w.metric, device=device).store
    del corpus
    qc = store.encode_queries(queries)
    full = _oracle(w, store, qc, None)
    return _Ctx(store, qc, None, full, _stable_top(full, k))


def _make_runner(w: S.Workload, ctx: _Ctx, cfg: TuneConfig) -> Callable:
    """A zero-arg (scores, ids) thunk executing ``cfg``: exactly what
    dispatch runs for this entry."""
    k = min(w.k, w.n)
    if cfg.impl == "scan":
        chunk = cfg.chunk or S.DEFAULT_CHUNK
        if w.kernel == "fused_adc":
            return lambda: scorer._topk_pq_from_lut(
                ctx.lut, ctx.store, k, w.metric, chunk)
        return lambda: scorer._scan_topk(ctx.q, ctx.store, k, w.metric, chunk)
    if w.kernel == "fused_adc":
        return lambda: K.fused_adc_topk(
            ctx.lut, ctx.store.codes, k, packed=ctx.store.packed,
            bq=cfg.bq, bn=cfg.bn)
    return lambda: K.fused_topk(
        ctx.q, ctx.store.data, k, w.metric, packed=ctx.store.packed,
        bq=cfg.bq, bn=cfg.bn)


def _parity_ok(ctx: _Ctx, s: torch.Tensor, i: torch.Tensor) -> bool:
    """Tie-robust bit parity against the oracle matrix (module docstring)."""
    s = s.to(torch.float32)
    if not torch.equal(s, ctx.top):
        return False
    i = i.long()
    if bool((i < 0).any()) or bool((i >= ctx.full.shape[1]).any()):
        return False
    # a row returned twice (a tile two splits scanned) can hide behind a tie
    srt = i.sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        return False
    return torch.equal(torch.gather(ctx.full, 1, i), s)


def autotune(
    workloads: Optional[Sequence[S.Workload]] = None,
    *,
    smoke: bool = False,
    seed: Optional[int] = None,
    repeats: int = 3,
    warmup: int = 1,
    margin: float = 0.03,
    max_candidates: int = 16,
    prune_ratio: float = 4.0,
    timer: Optional[Callable] = None,
    verbose: bool = False,
    device=None,
) -> TuneTable:
    """Measure the workloads on ``device`` (default: the card, or the CPU
    where the runtime profile asks for it) and return the ``TuneTable``.

    The table is NOT installed: callers decide (``table.install`` for this
    process, ``to_json`` / ``save_state`` for persistence)."""
    prof = rtprofile.active()
    seed = prof.seed if seed is None else int(seed)
    timer = timer or wall_timer
    workloads = (default_workloads(smoke) if workloads is None
                 else tuple(workloads))
    dev = resolve_device(device)
    stamp = live_stamp()
    backend = "cuda" if dev.type == "cuda" else "cpu"
    if stamp["backend"] != backend:
        raise ValueError(
            f"autotune on {dev} in a process whose runtime stamp says "
            f"{stamp['backend']!r}: a table is stamped with where it was "
            "measured, so measure where the process serves")
    table = TuneTable(stamp=stamp)

    for wi, w in enumerate(workloads):
        ctx = _build_ctx(w, workload_seed(seed, wi), dev)
        default_cfg = S.default_config(w, backend)
        cands = S.prune(w, S.candidates(w, backend), ratio=prune_ratio,
                        keep=default_cfg)
        cands = sorted(cands, key=lambda c: (S.estimate(w, c), repr(c)))
        cands = cands[:max_candidates]
        if default_cfg not in cands:
            cands.append(default_cfg)

        timed: list[tuple[float, TuneConfig]] = []
        for cfg in cands:
            fn = _make_runner(w, ctx, cfg)
            s, i = fn()
            if not _parity_ok(ctx, s, i):
                raise AssertionError(
                    f"tuner candidate {cfg} failed bit-parity against the "
                    f"reference oracle on {w}"
                )
            t = timer(fn, cfg=cfg, workload=w, repeats=repeats,
                      warmup=warmup)
            timed.append((t, cfg))
            if verbose:
                print(f"[tune]   {w.kernel} {w.metric} bits={w.bits}: "
                      f"{cfg.impl} bq={cfg.bq} bn={cfg.bn} "
                      f"chunk={cfg.chunk} {t * 1e6:.1f} us", flush=True)
        del ctx

        default_t = next(t for t, c in timed if c == default_cfg)
        best_t, best_cfg = min(timed, key=lambda tc: tc[0])
        chosen, chosen_t = default_cfg, default_t
        # hysteresis: a candidate must *clearly* beat the default
        if best_cfg != default_cfg and best_t < default_t * (1.0 - margin):
            chosen, chosen_t = best_cfg, best_t
        entry = dataclasses.replace(chosen, measured_us=chosen_t * 1e6,
                                    default_us=default_t * 1e6)
        key = table.put(w.kernel, w.metric, w.bits, w.q, w.n, w.d, entry)
        if verbose:
            print(f"[tune] {key} -> {entry.impl} bq={entry.bq} "
                  f"bn={entry.bn} chunk={entry.chunk} "
                  f"({len(timed)} candidates, chosen {chosen_t * 1e6:.1f} us "
                  f"vs default {default_t * 1e6:.1f} us)", flush=True)
    return table.check()

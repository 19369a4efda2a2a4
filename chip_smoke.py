#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase at full size, one card

Phases (each prints its lines; any failure exits non-zero):

  1. device   card name, power limit (nvidia-smi)
  2. build    nvcc builds every kernel in src/repro_torch/csrc (timed)
  3. kernels  each kernel against its plain PyTorch version on the card at
              ragged shapes (B1, the int arms of B2/B3 and the ADC kernels
              B4/B5 bit-equal; B2 fp32 within rtol 1e-5 of the plain
              version and of a float64 product, ids equal outside
              near-ties, its error against float64 logged beside the plain
              version's), at k past 1024 (1025, 3000) and B4/B5 LUTs of
              M = 256-1024, the fp32 kernel's tile edges, and a CUDA
              flat,lpq4+r32 search at k=300 against the CPU's; then each
              kernel's time at its main-path
              shape (B1-B3: 4,000,000 x 256, one 256-query bucket, k=100; B4:
              pq32 and B5: pq64x4 codes of 4,000,000 rows, 256 queries,
              k=100) beside the plain version's, the library yardstick's and
              the bound, with its result there held against the plain
              version's and the yardstick's scores (B2 int8 also at 1 and 32
              queries, k = 10 and 400, and l2 at the SIFT-like 1,000,000 x
              128, held bit-equal there; B3 at 1 and 32 queries, at k=400
              and l2 at 1,000,000 x 128, and B4 and B5 at k=400, each held
              bit-equal there); the score-matrix
              kernels B6-B8 bit-equal to their plain versions at ragged Q, N
              and d and on extreme codes, and timed at the retrieval shapes
              (1,000,000 x 128, Q=512; B6/B7 also Q=1)
  4. main     the main path at full width through make_index + Searcher:
              product-like 4,000,000 x 256 (flat, flat,lpq8@gaussian:3,
              flat,lpq4, flat,lpq4+r32, pq32+lpq, pq64x4+lpq,
              pq64x4+lpq,r32; ip), SIFT-like 1,000,000 x 128
              (flat,lpq8@global_minmax, pq16+lpq, pq16; l2), GloVe-like
              1,183,514 x 100 (flat,lpq8@global_absmax; angular):
              recall@100 against the fp32 flat arm, memory ratio, QPS, p50
              latency, build seconds; each corpus is one run of the path,
              with the launch counters set to 0 before it and read after,
              and every kernel's count must have risen; then the
              full-size corpus codes equal the plain quantize's, and every
              scan arm's kernel, at each Searcher bucket (1, 8, 32, 256
              queries) and its scan depth (k=100; +r32 / ,r32: 400), equals
              the plain version bit for bit for int8/int4/ADC (fp32 within
              rtol 1e-5), the ADC arms given the same int8 LUT
  5. table2   the paper's Table 2 protocol at n=20000, 128 queries: recall@100
              within 0.02 of the reference's 0.983 / 0.722 / 0.984 / 0.972;
              the PQ arms of phase 4 within max(0.03, the reference's spread
              over three seeds) of the reference's mean recall
  6. retrieval  recsys candidate retrieval at full width (DLRM-MLPerf
              retrieval_cand: 1,000,000 x 128 candidates, k=100) through
              QuantizedTable.from_dense + make_retrieval, int8 (B1 + B6)
              and fp32 arms, single-query and 512-query requests: p50, QPS,
              each request's parts, recall@100 int8 vs fp32, the memory
              ratio against the reference's formula, one B1 and one B6
              launch per quantized request, ids and scores equal to the
              plain path's; then the public score-matrix ops (B6-B8) as
              one run of their own; then recall@100 at n=20000 within 0.01
              of the reference's (REF_RETRIEVAL_RECALL)
  7. graph    the graph walk and HNSW: (a) hnsw8 int8 ip / l2 / angular
              and packed-int4 arms at 4,000 x 64, built on the card and on
              the CPU from the same levels: adjacency and entry equal, and a
              bucketed Searcher's ids and scores equal at ef_search 40 and
              80 (fp32 hnsw8: recall@10 within 0.01); (c) the paper's arm
              hnsw32,lpq8@gaussian:3 and hnsw32 (ef_construction 300, batch
              256) at product-like GRAPH_N (20,000) x 256 as one run of the
              main path (counters set to 0 before, read after): build
              seconds, memory against the reference's formula, recall@100,
              QPS and p50 at 256-query requests and the mixed 1/8/32
              stream, then one request's walk steps, iterations a query, B1
              launches (1 int8, 0 fp32) and kernels a step (torch.profiler,
              at ef_search 300); (b) on (c)'s builds, 128 queries:
              recall@100 at ef_search 300 and 800 within max(0.02, the
              reference's spread) of the reference's mean (REF_HNSW)
  8. index  the NGT-style graph index and the ivf kind: (a) graph8 int8 ip
              (augmented to d+1) / l2 / angular and packed-int4 arms and
              ivf32 int8 ip / l2 and int4 arms at 4,000 x 64, built on the
              card and on the CPU from the same k-means centroids, ip
              augmentation column and Eq. 1 constants (made once on the
              CPU): codes, adjacency, seeds and seed ids or lists and
              centroids equal, and a bucketed Searcher's ids and scores
              equal (graph at ef_search 40 and 80, ivf at nprobe 4 and 16;
              fp32 graph8 / ivf32: recall@10 within 0.01); (b) Table 3's
              arm pairs (graph24 and graph24,<fragment> on SIFT-like l2,
              GloVe-like angular and product-like ip) at ef_search 300 and
              ivf128,lpq8@global_minmax / ivf128 at nprobe 8 and 32, 20,000
              rows, 128 queries: recall@100 within max(0.02, the
              reference's spread) of the reference's mean (REF_GRAPH); (c)
              graph24,lpq8@global_minmax, graph24 (ef_search 300),
              ivf1024,lpq8@global_minmax and ivf1024 (nprobe 16 and 64) at
              SIFT-like 1,000,000 x 128, and graph24,lpq8@gaussian:3 at
              product-like 250,000 x 256 (its walk at width 257; 10^6 rows
              until the runtime phase 11 needed the room: the build's
              self-join is quadratic in N), as one
              run of the main path (counters set to 0 before, read after):
              build seconds and their parts, memory against the
              reference's formula, recall@100, QPS and p50 at 256-query
              requests and the mixed 1/8/32 stream; then each graph arm's
              steps and kernels a step (torch.profiler), each ivf arm's
              bytes a fine-scoring block gathers, and 1,024 rows of the
              width-257 self-join (B2 int8, Q = 1,024 of N = 250,000) held
              bit-equal to the plain version
  9. filter / stream  filtered search through every kind and the stream
              kind: (a) at 4,000 x 64, every ported kind (flat, int8, int4
              +r32, pq16+lpq, pq16x4,lpq8, ivf32, hnsw8, graph8 and a stream
              arm with segments and a memtable) filtered at 0.02 / 0.25 /
              0.9 equal to its own exhaustive ranking cut to the allowed
              rows (scores bit-equal, ids up to tie order); the integer
              flat, ivf, hnsw and graph arms built on the card and on the
              CPU from one set of draws give equal filtered results; one
              write sequence on stream(flat,lpq8@global_minmax) and
              stream(flat,lpq4@global_absmax)+r32 (seal_threshold 512) gives
              equal segments, ids, live bitmaps, counters and epoch on both,
              and equal filtered Searcher results (bit for bit where one
              integer source passes through, fp32 merges within rtol 1e-5);
              (b) filtered search at full width as runs of the main path:
              product-like 4,000,000 x 256 ip (flat, flat,lpq8@gaussian:3,
              flat,lpq4, pq32+lpq, pq64x4+lpq) and SIFT-like 1,000,000 x 128
              l2 (ivf1024 at nprobe 64, graph24 at ef_search 300), each
              selectivity beside the unfiltered (p50, QPS, ratio, at
              256-query requests and in the mixed stream), no disallowed id,
              flat equal to a flat scan over the allowed rows alone, and
              every masked kernel launch (B2-B5, ivf's masked probe) held
              against its plain version given the same mask at every
              bucket; (c) the stream kind at 4,000,000 x 256 ip
              (stream(flat,lpq8@gaussian:3), stream(flat,lpq4)+r32): a bulk
              build, STREAM_ROUNDS rounds of upserts, deletes, a replan and
              a request (write, seal, compaction and merge-store seconds),
              the churned snapshot against the fresh build, recall@100
              against an exact scan of live_items(), one filtered request,
              and compact(full=True) bit-equal to a from-scratch build
 10. cascade / regions  the cascade kind and per-region Eq. 1 constants:
              (a) at the reference conformance's 384 x 32, its arms
              cascade(flat,lpq4|r32), cascade(pq16x4|lpq8|r32),
              ivf8,lpq8,regions, hnsw8,lpq8,regions and
              graph16,lpq4,regions built on the card and on the CPU from
              one set of draws: codes and region constants equal, integer
              head scans, stages and walks bit-equal, fp32 stages and
              regional re-scores within rtol 1e-5, a bucketed Searcher
              unfiltered and filtered at 0.02 / 0.25 / 0.9; one write
              sequence on stream(cascade(flat,lpq8|r32)) equal on both;
              cascade(flat|r32) at budgets (n,) equal to the exact flat
              scan; (b) recall at 20,000 rows within max(0.02, the
              reference's spread) of the reference's mean (REF_CASCADE):
              the two cascades at bench_cascade's budgets (recall@10),
              ivf128 / graph24 ,lpq8@global_minmax,regions (SIFT-like) and
              hnsw32,lpq8@gaussian:3,regions (product-like); (c) one run
              of the main path on phase 9's product-like 4,000,000 x 256
              rows (the cascades at their budgets beside
              flat,lpq8@gaussian:3 and flat,lpq4, k=10: recall@10, memory
              ratio, QPS, p50, stage rows, model bytes a query,
              bench_cascade's gate logged) and SIFT-like 1,000,000 x 128
              (ivf1024 and graph24 ,lpq8@global_minmax,regions: build
              seconds by part, memory against the reference's formula,
              recall@100, QPS, p50), then every kernel scan it launched
              held against its plain version
 11. tune / runtime  (a) the autotuner (``repro_torch.tune``) at the
              main path's widths and phase 4's n bucket (4,000,000 rows,
              Q=256, k=100: B2 int8 ip d=256 and l2 d=128, B3 ip d=256,
              B4 pq32, B5 pq64x4, the angular scan d=100), every candidate
              layout held bit-equal to its plain version before it is
              timed, each entry logged, the table written to JSON and read
              back with the same hash; then (b) and (c) as one run of the
              path (counters set to 0 before, read after): (b) phase 9's
              product-like rows through flat,lpq8@gaussian:3, flat,lpq4,
              pq32+lpq and pq64x4+lpq Searchers planned with the table
              and without: ids and scores bit-equal, stats["tuned"] and
              bytes read as each plan's table says, B2-B5 launched by
              both, p50 in turns (untuned, tuned, tuned, untuned), and an
              index saved with the table adopting it on load; (c) a
              result-cache repeat that hits bit-identical and launches
              nothing, the LUT cache on an eager pq32+lpq search, a
              maintenance thread compacting stream(flat,lpq8@gaussian:3)
              at 250,000 x 256 while requests are served (waiting on its
              swap event), a forced full compaction bit-equal to a
              from-scratch build on live_items(), an admission burst
              under an injected clock, the telemetry summary and the
              runtime stamp
 12. dist     sharded plans on ["cuda:0"] * s meshes and replicas: each
              sharded request and the replica set's serving is a run of
              the path, counted alone (counters set to 0 just before, read
              just after; the plans it is held against run outside), and
              B1-B6 must each launch on them: (a) every arm of the reference's
              SHARDED_ARMS at 4,000 x 64 (the stream arm with writes),
              planned at 1, 2 and 4 shards, unfiltered and at 0.25: ids
              and scores bit-equal to the card's unsharded plan, and for
              flat,lpq4 / pq16x4,lpq8 / ivf8,lpq8 to the CPU's sharded plan
              too; (b) phase 11's product-like builds (flat,lpq8@gaussian:3,
              pq32+lpq, pq64x4+lpq) and flat,lpq4+r32 at 1, 2 and 4 shards,
              each shard launching the arm's kernel, bit-equal to the
              unsharded plan, p50 of 256-query requests beside it;
              SIFT-like ivf1024,lpq8@global_minmax at nprobe 16 on 4
              shards, its probe launching B2 fp32; retrieval_cand (10^6 x
              128, Q=512) through make_retrieval_sharded on 4 shards, B1
              and B6 launched once a shard, bit-equal to
              make_retrieval; balance and merge bytes logged; (c) a
              ReplicaSet of two flat,lpq8@gaussian:3 Searchers serving 32
              requests, each equal to the plain Searcher's, its telemetry
              counters logged

Output: one JSON line of kernel records (times and bound at each record's
``shape``, launches summed over the runs of phase 4, the retrieval path,
the score-matrix ops, the HNSW path, the graph / ivf path, phase 9(b)
and (c), phase 10(c), phase 11(b)-(c) and phase 12), then the
card's name and power limit, then the last line ``{"ok": true, "device": {...}}``.  With no CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

if (SRC / "repro_torch").is_dir():       # main() refuses to run without it
    sys.path.insert(0, str(SRC))
    # the H100's published peaks, which the tuner's cost model shares
    from repro_torch.tune.space import (  # noqa: E402
        PEAK_BYTES,
        PEAK_FP32,
        PEAK_INT8,
        PEAK_INT32,
    )

REPS = 20                   # timed kernel calls (median)
PLAIN_REPS = 5              # timed plain-version and library calls (median)
BUCKETS = (1, 8, 32, 256)   # the Searcher's batch buckets

#: the reference's Table 2 recalls at n=20000, 128 queries, k=100
TABLE2 = {
    ("product", "flat,lpq8@gaussian:3"): 0.983,
    ("product", "flat,lpq4"): 0.722,
    ("sift", "flat,lpq8@global_minmax"): 0.984,
    ("glove", "flat,lpq8@global_absmax"): 0.972,
}

#: the reference's PQ recall@100 at n=20000, 128 queries: (mean, spread =
#: max - min) over three seeds of data and k-means inits, measured on the
#: CPU by scripts/pq_reference_recall.py
REF_PQ = {
    ("product", "pq32+lpq"): (0.4381, 0.0030),
    ("product", "pq64x4+lpq"): (0.4156, 0.0090),
    ("product", "pq64x4+lpq,r32"): (0.7644, 0.0124),
    ("sift", "pq16+lpq"): (0.4216, 0.0010),
    ("sift", "pq16"): (0.4243, 0.0022),
}

#: the reference's int8-vs-fp32 recall@100 of candidate retrieval at
#: n=20000, d=128, 128 queries on retrieval_data(..., seed=0), measured on
#: the CPU by scripts/recsys_reference_recall.py
REF_RETRIEVAL_RECALL = 0.8503


class SmokeFailure(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _codes(g, shape, small: bool, dev, dtype):
    import torch

    lo, hi = (-2, 3) if small else (-128, 128)
    return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)


def _rel_err(q, x, metric, s, ids, scale) -> float:
    """Largest |score - exact| / row scale over the valid slots, each
    returned id's exact score recomputed in float64."""
    import torch

    valid = ids >= 0
    q64, rows = q.double(), x[ids.clamp_min(0).long()].double()   # [Q, k, d]
    dot = torch.einsum("qd,qkd->qk", q64, rows)
    exact = dot if metric == "ip" else -((q64 * q64).sum(1, keepdim=True)
                                         + (rows * rows).sum(2) - 2 * dot)
    err = ((s.double() - exact).abs() / scale)[valid]
    return float(err.max()) if err.numel() else 0.0


def _check_fp32(q, x, k, metric, mask, got, want):
    """fp32: scores within rtol 1e-5 of the row scale (max |plain score| +
    1) of the plain version's at every rank, and every returned id's own
    score, recomputed in float64, within the same tolerance of the score
    returned beside it, so ids can differ from the plain version's only
    inside near-tie groups.  Also measures the kernel's and the plain
    version's |score - float64| / row scale (ROADMAP C6: the kernel's one
    fmaf chain over d does not stay within max(1e-6, the plain version's
    error) at d = 256, so the gate stays at 1e-5).  Returns (id swaps,
    kernel error, plain error)."""
    import torch

    (gs, gi), (ws, wi) = got, want
    valid = wi >= 0
    need(torch.equal(gi >= 0, valid), "fp32: sentinel slots differ")
    need(bool(torch.all(gs[~valid] == ws[~valid])), "fp32: sentinel scores differ")
    scale = torch.where(valid, ws.abs(), 0).amax(dim=1, keepdim=True).double() + 1.0
    rank = ((gs.double() - ws.double()).abs() / scale)[valid]
    need(rank.numel() == 0 or float(rank.max()) <= 1e-5,
         "fp32 scores beyond rtol 1e-5 of the plain version's")
    plain_err = _rel_err(q, x, metric, ws, wi, scale)
    kern_err = _rel_err(q, x, metric, gs, gi, scale)
    need(kern_err <= 1e-5,
         "fp32: a returned id's own score disagrees with its returned score")
    if mask is not None:
        ids = gi.clamp_min(0).long()
        need(bool(torch.all(mask[ids][valid] != 0)), "fp32: a masked row returned")
    return int((gi != wi).sum()), kern_err, plain_err


#: the largest fp32 |score - float64| / row scale over the checks, kernel
#: and plain version (ROADMAP C6)
FP32_ERR = {"kernel": 0.0, "plain": 0.0}

KERNEL_OF = {"int8": "fused_topk_int8", "fp32": "fused_topk_fp32",
             "int4": "fused_topk4"}
ADC_KERNELS = ("fused_adc", "fused_adc4")
#: the kernels of the ANN main path (phase 4)
MAIN_KERNELS = ("quantize", *KERNEL_OF.values(), *ADC_KERNELS)


def hold(name, got, want, q, x, k, metric, mask, tag, err) -> int:
    """A fused kernel's result against its plain version: the int arms
    bit-equal in ids and scores, fp32 through ``_check_fp32``.  Raises the
    largest |kernel - plain| in ``err[name]``; returns the fp32 near-tie id
    swaps."""
    import torch

    if name != "fused_topk_fp32":
        need(torch.equal(got[1], want[1]), f"ids differ from the plain version: {tag}")
        need(torch.equal(got[0], want[0]), f"scores differ from the plain version: {tag}")
        return 0
    swaps, kern_err, plain_err = _check_fp32(q, x, k, metric, mask, got, want)
    FP32_ERR["kernel"] = max(FP32_ERR["kernel"], kern_err)
    FP32_ERR["plain"] = max(FP32_ERR["plain"], plain_err)
    e = (got[0] - want[0]).abs()[want[1] >= 0]
    if e.numel():
        err[name] = max(err[name], float(e.max()))
    return swaps


def check_kernels(err: dict) -> None:
    """Every kernel against its plain version on the card at ragged shapes."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import ref as R

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    # B1: ragged shapes, learned constants, plus exact .5 rounding points
    for n in (1, 511, 70001):
        for d in (64, 128, 256, 257):
            x = torch.randn(n, d, generator=g, device=dev) * 0.05
            lo = -torch.rand(d, generator=g, device=dev) * 0.1 - 0.01
            hi = torch.rand(d, generator=g, device=dev) * 0.1 + 0.01
            zero = (lo + hi) / 2
            for bits in (8, 4):
                got = QZ.quantize_cuda(x, lo, hi, zero, bits=bits)
                want = R.quantize_ref(x, lo, hi, zero, bits=bits)
                need(torch.equal(got, want), f"B1 codes differ n={n} d={d} b={bits}")
                cpu = R.quantize_ref(x.cpu(), lo.cpu(), hi.cpu(), zero.cpu(), bits=bits)
                need(torch.equal(got.cpu(), cpu), f"B1 vs CPU plain n={n} d={d}")
    half = (torch.arange(-300, 300, device=dev, dtype=torch.float32) + 0.5) / 256
    ones = torch.ones(half.shape[0], device=dev)
    got = QZ.quantize_cuda(half[None], -0.5 * ones, 0.5 * ones, 0 * ones, bits=8)
    want = R.quantize_ref(half[None], -0.5 * ones, 0.5 * ones, 0 * ones, bits=8)
    need(torch.equal(got, want), "B1 differs at exact .5 rounding points")

    case = 0
    n_tie_swaps = 0
    for kind in ("int8", "fp32", "int4"):
        ds = {"int8": (64, 128, 256, 257), "fp32": (64, 128, 256, 257),
              "int4": (64, 128, 256, 258)}[kind]
        for Q in (1, 37, 300):
            for N in (1, 511, 70001):
                for metric in ("ip", "l2"):
                    for masked in (False, True):
                        d = ds[case % len(ds)]
                        k = (1, 100, 400)[(case // 2) % 3]
                        small = case % 3 == 0
                        case += 1
                        mask = None
                        if masked:
                            keep = 0.5 if case % 4 else 0.002
                            mask = (torch.rand(N, generator=g, device=dev)
                                    < keep).to(torch.int8)
                        kk = min(k, N)
                        if kind == "fp32":
                            q = torch.randn(Q, d, generator=g, device=dev)
                            x = torch.randn(N, d, generator=g, device=dev)
                            got = K.fused_topk(q, x, k, metric, mask=mask)
                            want = F.fused_topk_plain(q, x, k=kk, metric=metric,
                                                      mask=mask)
                        elif kind == "int4":
                            q = _codes(g, (Q, d), small, dev, torch.int8).clamp(-8, 7)
                            x = PK.pack_int4(_codes(g, (N, d), small, dev,
                                                    torch.int8).clamp(-8, 7))
                            got = K.fused_topk(q, x, k, metric, packed=True,
                                               mask=mask)
                            qe, qo = K.split_nibble_queries(q)
                            want = F.fused_topk4_plain(qe, qo, x, k=kk,
                                                       metric=metric, mask=mask)
                        else:
                            q = _codes(g, (Q, d), small, dev, torch.int8)
                            x = _codes(g, (N, d), small, dev, torch.int8)
                            got = K.fused_topk(q, x, k, metric, mask=mask)
                            want = F.fused_topk_plain(q, x, k=kk, metric=metric,
                                                      mask=mask)
                        tag = f"{kind} Q={Q} N={N} d={d} k={k} {metric} mask={masked}"
                        n_tie_swaps += hold(KERNEL_OF[kind], got, want, q, x, kk,
                                            metric, mask, tag, err)
    log(f"[kernels] {case} fused cases + B1 sweep agree with the plain versions "
        f"(fp32 near-tie id swaps: {n_tie_swaps}); max_abs_err {err}")


def adc_plain(lut, codes, k, packed, mask=None):
    """The plain B4 / B5 on the operands ``ops.fused_adc_topk`` hands the
    kernels: the odd-M zero LUT slice and the even/odd split for packed
    codes, the flat [Q, M*K] LUT otherwise."""
    import torch

    from repro_torch.kernels import adc as A

    Q = lut.shape[0]
    if packed:
        full = torch.nn.functional.pad(
            lut, (0, 0, 0, 2 * codes.shape[1] - lut.shape[1]))
        return A.fused_adc4_plain(full[:, 0::2].reshape(Q, -1).contiguous(),
                                  full[:, 1::2].reshape(Q, -1).contiguous(),
                                  codes, k=k, mask=mask)
    return A.fused_adc_plain(lut.reshape(Q, -1), codes, k=k,
                             n_codewords=lut.shape[2], mask=mask)


def hold_adc(got, want, tag) -> None:
    """B4 / B5 against the plain version: bit-equal ids and scores."""
    import torch

    need(torch.equal(got[1], want[1]), f"ADC ids differ from the plain version: {tag}")
    need(torch.equal(got[0], want[0]), f"ADC scores differ from the plain version: {tag}")


def check_adc() -> None:
    """B4 and B5 against their plain versions at ragged shapes: Q, N, M
    (odd M for the packed layout), k, with and without a mask, and LUTs of
    small values (many exact ties) or the full int8 range."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    case = 0
    for name, bits in (("fused_adc", 8), ("fused_adc4", 4)):
        kc = 2 ** bits
        for Q in (1, 37, 300):
            for N in (1, 511, 70001):
                for masked in (False, True):
                    m = (32, 7, 64)[case % 3]
                    k = (1, 100, 400)[(case // 2) % 3]
                    lo, hi = (-2, 3) if case % 4 == 0 else (-128, 128)
                    case += 1
                    lut = torch.randint(lo, hi, (Q, m, kc), generator=g,
                                        device=dev).to(torch.int8)
                    codes = torch.randint(0, kc, (N, m), generator=g,
                                          device=dev).to(torch.uint8)
                    if bits == 4:
                        codes = PK.pack_uint4(codes)
                    mask = None
                    if masked:
                        keep = 0.5 if case % 4 else 0.002
                        mask = (torch.rand(N, generator=g, device=dev)
                                < keep).to(torch.int8)
                    got = K.fused_adc_topk(lut, codes, k, packed=bits == 4,
                                           mask=mask)
                    want = adc_plain(lut, codes, min(k, N), bits == 4, mask)
                    hold_adc(got, want, f"{name} Q={Q} N={N} M={m} k={k} "
                             f"lut=[{lo},{hi}) mask={masked}")
    log(f"[kernels] {case} fused ADC cases (B4, B5) bit-equal to the plain "
        "versions")


def check_any_k(err: dict) -> None:
    """ROADMAP C5 on the card: B2 (int8, fp32) and B3 at k = 1024, 1025 and
    3000 (buffers in global memory past k = 2016), B4 / B5 at M = 256, 512
    and 1024 at Q = 1, 3 (the gather kernel) and 9 (B4's word kernel, B5's
    MMA kernel) and k = 100 and 1025, and B4 batches of at most 4 queries
    at the gather kernel's other instances (lists in global memory at 1, 2
    and 4 queries a block), each with and without a mask; the fp32 kernel's
    edges (Q at each query tile and one past it, N past a tile and a
    split, d not a multiple of 4, an unaligned view); and a CUDA
    ``flat,lpq4+r32`` search at k=300 (scan depth 1200) against the same
    index on the CPU.  Integer paths bit-equal, fp32 by C6's rule."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K
    from repro_torch.knn import make_index

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    Q, N, d = 37, 70001, 64
    cases = 0
    for kind in ("int8", "fp32", "int4"):
        for k in (1024, 1025, 3000):
            for metric, masked in (("ip", False), ("l2", True)):
                mask = ((torch.rand(N, generator=g, device=dev) < 0.5)
                        .to(torch.int8) if masked else None)
                if kind == "fp32":
                    q = torch.randn(Q, d, generator=g, device=dev)
                    x = torch.randn(N, d, generator=g, device=dev)
                else:
                    lim = 8 if kind == "int4" else 128
                    q = torch.randint(-lim, lim, (Q, d), generator=g,
                                      device=dev).to(torch.int8)
                    x = torch.randint(-lim, lim, (N, d), generator=g,
                                      device=dev).to(torch.int8)
                if kind == "int4":
                    x = PK.pack_int4(x)
                    got = K.fused_topk(q, x, k, metric, packed=True, mask=mask)
                    want = F.fused_topk4_plain(*K.split_nibble_queries(q), x,
                                               k=k, metric=metric, mask=mask)
                else:
                    got = K.fused_topk(q, x, k, metric, mask=mask)
                    want = F.fused_topk_plain(q, x, k=k, metric=metric,
                                              mask=mask)
                hold(KERNEL_OF[kind], got, want, q, x, k, metric, mask,
                     f"{kind} Q={Q} N={N} k={k} {metric} mask={masked}", err)
                cases += 1
    # (bits, M, Q, k): as tests/test_torch_gpu.py ADC_WIDE, every B4
    # gather-kernel instance among them
    wide = ([(bits, m, qn, k)
             for bits, m in ((8, 256), (8, 512), (8, 1024), (4, 256),
                             (4, 1024))
             for qn in (1, 3, 9) for k in (100, 1025)]
            + [(8, 512, 1, 3000), (8, 256, 2, 3000), (8, 256, 3, 3000),
               (8, 128, 3, 100), (8, 128, 3, 1025), (8, 128, 2, 100)])
    for bits, m, qn, k in wide:
        kc = 2 ** bits
        lut = torch.randint(-128, 128, (qn, m, kc), generator=g,
                            device=dev).to(torch.int8)
        codes = torch.randint(0, kc, (20001, m), generator=g,
                              device=dev).to(torch.uint8)
        payload = PK.pack_uint4(codes) if bits == 4 else codes
        mask = (torch.rand(20001, generator=g, device=dev) < 0.5).to(torch.int8)
        for mk in (None, mask):
            got = K.fused_adc_topk(lut, payload, k, packed=bits == 4, mask=mk)
            want = adc_plain(lut, payload, k, bits == 4, mk)
            hold_adc(got, want,
                     f"M={m} K={kc} Q={qn} k={k} mask={mk is not None}")
            cases += 1
    edges = ([(q, 5000, 64, 0) for q in (1, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65)]
             + [(9, n, 32, 0) for n in (255, 256, 257, 2048, 2049)]
             + [(7, 3001, dd, 0) for dd in (1, 3, 100, 255)]
             + [(7, 3001, dd, 1) for dd in (64, 100)])
    for Qe, Ne, de, off in edges:
        for metric in ("ip", "l2"):
            q = torch.randn(Qe, de, generator=g, device=dev)
            x = torch.randn(Ne * de + off, generator=g,
                            device=dev)[off:].view(Ne, de)
            need(off == 0 or x.data_ptr() % 16 != 0, "edge view is aligned")
            ke = min(100, Ne)
            got = K.fused_topk(q, x, ke, metric)
            want = F.fused_topk_plain(q, x, k=ke, metric=metric)
            hold("fused_topk_fp32", got, want, q, x, ke, metric, None,
                 f"fp32 edge Q={Qe} N={Ne} d={de} offset={off} {metric}", err)
            cases += 1
    gen = torch.Generator().manual_seed(8)
    corpus = torch.randn(30000, 64, generator=gen)
    queries = torch.randn(16, 64, generator=gen)
    gpu = make_index("flat,lpq4+r32", corpus, metric="ip", device=dev)
    cpu = make_index("flat,lpq4+r32", corpus, metric="ip", device="cpu")
    need(torch.equal(gpu.store.data.cpu(), cpu.store.data),
         "+r32: CUDA and CPU codes differ")
    qc = gpu.store.encode_queries(queries.to(dev))
    got = K.fused_topk(qc, gpu.store.data, 1200, "ip", packed=True)
    want = K.fused_topk(qc.cpu(), cpu.store.data, 1200, "ip", packed=True)
    need(torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0]),
         "+r32: the depth-1200 B3 scan differs from the CPU's")
    srch = gpu.searcher(300)
    need(srch.rerank is not None and srch.rerank.depth == 1200,
         "+r32 at k=300: scan depth is not 1200")
    res, ref = srch(queries.to(dev)), cpu.searcher(300)(queries)
    scale = ref.scores.abs().amax(dim=1, keepdim=True) + 1.0
    need(bool(torch.all((res.scores.cpu() - ref.scores).abs() <= 1e-6 * scale))
         and (res.ids.cpu() != ref.ids).float().mean().item() < 0.01,
         "+r32 at k=300: the CUDA search differs from the CPU's")
    log(f"[kernels] C5: {cases} cases at k in (1024, 1025, 3000), M up to 1024 "
        "and the fp32 edges agree with the plain versions; the CUDA "
        "flat,lpq4+r32 search at k=300 (depth 1200) matches the CPU's")


def library_topk(q, x, k, packed=False, chunk=1 << 20):
    """Yardstick only (never used by the port): one library GEMM per corpus
    chunk plus ``torch.topk``, ip.  int8 codes (and int4 codes, unpacked
    chunk by chunk) go through ``torch._int_mm``, int8 tensor cores with
    exact int32 sums; fp32 through ``torch.matmul``, cuBLAS SGEMM with TF32
    off."""
    import torch

    from repro_torch.core import pack as PK

    best_s, best_i = [], []
    for s in range(0, x.shape[0], chunk):
        xc = PK.unpack_int4(x[s:s + chunk]) if packed else x[s:s + chunk]
        sc = torch._int_mm(q, xc.T) if q.dtype == torch.int8 else q @ xc.T
        v, i = torch.topk(sc, min(k, sc.shape[1]), dim=1)
        best_s.append(v.float())
        best_i.append(i + s)
    v, pos = torch.topk(torch.cat(best_s, 1), k, dim=1)
    return v, torch.gather(torch.cat(best_i, 1), 1, pos)


def time_kernels(err: dict) -> dict:
    """Each kernel at the main-path shapes: 4,000,000 x 256 corpus, one
    256-query bucket, k=100; B1 at the corpus encode.  Each result is held
    against the plain version's at that shape, and the library yardstick's
    scores against the kernel's."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import ref as R

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    N, d, Q, k = 4_000_000, 256, 256, 100
    out = {}

    x = torch.randn(N, d, generator=g, device=dev) * 0.05
    lo, hi = -0.1 * torch.ones(d, device=dev), 0.1 * torch.ones(d, device=dev)
    zero = torch.zeros(d, device=dev)
    ms = time_ms(lambda: QZ.quantize_cuda(x, lo, hi, zero, bits=8), REPS)
    pm = time_ms(lambda: R.quantize_ref(x, lo, hi, zero, bits=8), PLAIN_REPS)
    codes = QZ.quantize_cuda(x, lo, hi, zero, bits=8)
    need(torch.equal(codes, R.quantize_ref(x, lo, hi, zero, bits=8)),
         f"B1 codes differ from the plain version at N={N} d={d}")
    nbytes = N * d * 5 + 3 * d * 4
    out["quantize"] = dict(ms=ms, plain_ms=pm, library_ms=None,
                           bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                           shape=f"N={N} d={d} bits=8",
                           bound_formula=f"({N}*{d} f32 in + {N}*{d} int8 out + "
                           f"3*{d} f32) B / 3.35e12 B/s")

    qf = torch.randn(Q, d, generator=g, device=dev) * 0.05
    qc = QZ.quantize_cuda(qf, lo, hi, zero, bits=8)
    c4 = PK.pack_int4(codes.clamp(-8, 7))
    q4 = qc.clamp(-8, 7)
    qe, qo = K.split_nibble_queries(q4)
    arms = {
        "fused_topk_int8": (lambda: F.fused_topk_cuda(qc, codes, k=k, metric="ip"),
                            lambda: F.fused_topk_plain(qc, codes, k=k, metric="ip"),
                            lambda: library_topk(qc, codes, k),
                            qc, codes, N * d + Q * d, PEAK_INT8),
        "fused_topk_fp32": (lambda: F.fused_topk_cuda(qf, x, k=k, metric="ip"),
                            lambda: F.fused_topk_plain(qf, x, k=k, metric="ip"),
                            lambda: library_topk(qf, x, k),
                            qf, x, (N * d + Q * d) * 4, PEAK_FP32),
        "fused_topk4": (lambda: F.fused_topk4_cuda(qe, qo, c4, k=k, metric="ip"),
                        lambda: F.fused_topk4_plain(qe, qo, c4, k=k, metric="ip"),
                        lambda: library_topk(q4, c4, k, packed=True),
                        q4, c4, N * d // 2 + Q * d, PEAK_INT8),
    }
    for name, (kern, plain, lib, q, xs, in_bytes, peak) in arms.items():
        ms = time_ms(kern, REPS)
        pm = time_ms(plain, PLAIN_REPS, warm=1)
        lm = time_ms(lib, PLAIN_REPS, warm=1)
        shape = f"Q={Q} N={N} d={d} k={k} ip"
        got = kern()
        swaps = hold(name, got, plain(), q, xs, k, "ip", None,
                     f"{name} {shape}", err)
        lib_s = lib()[0]
        tol = 1e-5 * (got[0].abs().amax(dim=1, keepdim=True) + 1.0)
        need(bool(torch.all((lib_s - got[0]).abs() <= tol)),
             f"{name}: the library yardstick's scores disagree at {shape}")
        log(f"[kernels] {name} {shape}: agrees with the plain version "
            f"(near-tie id swaps: {swaps}) and with the library's scores")
        t_bytes = (in_bytes + Q * k * 8) / PEAK_BYTES * 1e3
        t_ops = 2.0 * Q * N * d / peak * 1e3
        out[name] = dict(ms=ms, plain_ms=pm, library_ms=lm,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         shape=shape, bound_formula=(
                             f"max(({in_bytes} in + {Q * k * 8} out) B / "
                             f"3.35e12 B/s = {t_bytes:.4f} ms, 2*{Q}*{N}*{d} "
                             f"ops / {peak:.4g} /s = {t_ops:.4f} ms)"))
    for name, r in out.items():
        log(f"[timing] {name} {r['shape']}: kernel {r['ms']:.4f} ms (median of "
            f"{REPS}), plain {r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), roofline "
            f"{r['bound_ms'] / r['ms']:.4f} | {smi()}")
    # request shapes of the int8 scan (bytes-bound), and its cost in k
    for qn in (1, 32):
        ms1 = time_ms(lambda: F.fused_topk_cuda(qc[:qn], codes, k=k, metric="ip"),
                      REPS)
        log(f"[timing] fused_topk_int8 Q={qn} N={N} d={d} k={k}: kernel "
            f"{ms1:.4f} ms, bound {(N * d) / PEAK_BYTES * 1e3:.4f} ms (bytes)"
            f" | {smi()}")
    for kk in (10, 400):
        msk = time_ms(lambda: F.fused_topk_cuda(qc, codes, k=kk, metric="ip"), REPS)
        log(f"[timing] fused_topk_int8 Q={Q} N={N} d={d} k={kk}: kernel "
            f"{msk:.4f} ms | {smi()}")
    # l2 at the SIFT-like shape (flat,lpq8@global_minmax's scan), held
    # bit-equal to the plain version there
    ns, ds = 1_000_000, 128
    xs = _codes(g, (ns, ds), False, dev, torch.int8)
    qs = _codes(g, (Q, ds), False, dev, torch.int8)
    msl = time_ms(lambda: F.fused_topk_cuda(qs, xs, k=k, metric="l2"), REPS)
    pml = time_ms(lambda: F.fused_topk_plain(qs, xs, k=k, metric="l2"),
                  PLAIN_REPS, warm=1)
    hold("fused_topk_int8", F.fused_topk_cuda(qs, xs, k=k, metric="l2"),
         F.fused_topk_plain(qs, xs, k=k, metric="l2"), qs, xs, k, "l2", None,
         f"int8 l2 Q={Q} N={ns} d={ds} k={k}", err)
    log(f"[timing] fused_topk_int8 Q={Q} N={ns} d={ds} k={k} l2: kernel "
        f"{msl:.4f} ms, plain {pml:.4f} ms, bound "
        f"{(ns * ds) / PEAK_BYTES * 1e3:.4f} ms (bytes); bit-equal to the "
        f"plain version | {smi()}")
    del xs, qs
    # B3 at request shapes (1 and 32 queries), at depth 400 and l2 at the
    # SIFT-like shape (1,000,000 x 128: 64 packed bytes a row), each held
    # bit-equal to the plain version there
    x4s = PK.pack_int4(_codes(g, (ns, ds), False, dev, torch.int8).clamp(-8, 7))
    q4s = _codes(g, (Q, ds), False, dev, torch.int8).clamp(-8, 7)
    for qn, kk, metric, qq, xx in ((1, k, "ip", q4, c4), (32, k, "ip", q4, c4),
                                   (Q, 400, "ip", q4, c4),
                                   (Q, k, "l2", q4s, x4s)):
        qe_, qo_ = K.split_nibble_queries(qq[:qn].contiguous())
        ms4 = time_ms(lambda: F.fused_topk4_cuda(qe_, qo_, xx, k=kk,
                                                 metric=metric), REPS)
        shape = f"Q={qn} N={xx.shape[0]} d={2 * xx.shape[1]} k={kk} {metric}"
        hold("fused_topk4", F.fused_topk4_cuda(qe_, qo_, xx, k=kk, metric=metric),
             F.fused_topk4_plain(qe_, qo_, xx, k=kk, metric=metric), qq[:qn],
             xx, kk, metric, None, f"int4 {shape}", err)
        log(f"[timing] fused_topk4 {shape}: kernel {ms4:.4f} ms, bound "
            f"{xx.numel() / PEAK_BYTES * 1e3:.4f} ms (code bytes); bit-equal "
            f"to the plain version | {smi()}")
    del x4s, q4s
    # the fp32 scan at a single request (bytes-bound) and at depth 400
    ms1 = time_ms(lambda: F.fused_topk_cuda(qf[:1], x, k=k, metric="ip"), REPS)
    log(f"[timing] fused_topk_fp32 Q=1 N={N} d={d} k={k}: kernel {ms1:.4f} ms, "
        f"bound {(N * d * 4) / PEAK_BYTES * 1e3:.4f} ms (bytes) | {smi()}")
    msk = time_ms(lambda: F.fused_topk_cuda(qf, x, k=400, metric="ip"), REPS)
    log(f"[timing] fused_topk_fp32 Q={Q} N={N} d={d} k=400: kernel {msk:.4f} "
        f"ms | {smi()}")
    dev_ms = device_ms(lambda: F.fused_topk_cuda(qf, x, k=k, metric="ip"),
                       ("f32_topk_kernel", "merge_topk_kernel"))
    log(f"[timing] fused_topk_fp32 Q={Q} k={k} device time per call (profiler, "
        f"3 calls): pass 1 {dev_ms['f32_topk_kernel']:.4f} ms, merge "
        f"{dev_ms['merge_topk_kernel']:.4f} ms")
    # device time of pass 1 and pass 2 (merge) of the int8 and int4 scans
    for name, fn in (
            ("fused_topk_int8",
             lambda: F.fused_topk_cuda(qc, codes, k=k, metric="ip")),
            ("fused_topk4",
             lambda: F.fused_topk4_cuda(qe, qo, c4, k=k, metric="ip"))):
        dev_ms = device_ms(fn, ("i8_topk_kernel", "merge_topk_kernel"))
        total = sum(dev_ms.values()) or 1.0
        log(f"[timing] {name} Q={Q} k={k} device time per call (profiler, "
            f"3 calls): pass 1 {dev_ms['i8_topk_kernel']:.4f} ms "
            f"({dev_ms['i8_topk_kernel'] / total:.1%}), merge "
            f"{dev_ms['merge_topk_kernel']:.4f} ms "
            f"({dev_ms['merge_topk_kernel'] / total:.1%})")
    return out


def device_ms(fn, names, calls=3) -> dict:
    """Profiler device time per call (ms) of the CUDA kernels whose name
    holds each of ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        t_us = getattr(ev, "device_time_total", None)
        if t_us is None:
            t_us = getattr(ev, "cuda_time_total", 0.0)
        for part in names:
            if part in ev.key:
                out[part] += t_us / calls / 1e3
    return out


def time_adc() -> dict:
    """B4 and B5 at their main-path shapes: the codes of a 4,000,000-row
    corpus under pq32 (B4: 32 code bytes a row) and pq64x4 (B5: 32 packed
    bytes a row), one 256-query bucket, k=100, random int8 LUTs.  Each
    result is held against the plain version's, and the library
    yardstick's scores against the kernel's.  The yardstick is one
    ``torch._int_mm`` of the [Q, M*K] LUT against the rows' [N, M*K]
    int8 one-hot per 1M-row chunk plus ``torch.topk``: the TPU kernel's
    own form, on int8 tensor cores, with the one-hot built before the
    clock starts."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import adc as A
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    N, Q, k = 4_000_000, 256, 100
    out = {}
    for name, m, bits in (("fused_adc", 32, 8), ("fused_adc4", 64, 4)):
        kc = 2 ** bits
        packed = bits == 4
        lut = torch.randint(-128, 128, (Q, m, kc), generator=g,
                            device=dev).to(torch.int8)
        codes = torch.randint(0, kc, (N, m), generator=g,
                              device=dev).to(torch.uint8)
        payload = PK.pack_uint4(codes) if packed else codes
        shape = f"Q={Q} N={N} M={m} K={kc} k={k}"

        def kern():
            return K.fused_adc_topk(lut, payload, k, packed=packed)

        def plain():
            return adc_plain(lut, payload, k, packed)

        ms = time_ms(kern, REPS)
        pm = time_ms(plain, PLAIN_REPS, warm=1)
        got = kern()
        hold_adc(got, plain(), f"{name} {shape}")
        onehot = torch.zeros((N, m * kc), dtype=torch.int8, device=dev)
        for s0 in range(0, N, 1 << 20):
            oh = onehot[s0:s0 + (1 << 20)].view(-1, m, kc)
            oh.scatter_(2, codes[s0:s0 + (1 << 20)].long().unsqueeze(-1), 1)
        lut2d = lut.reshape(Q, -1).contiguous()
        lm = time_ms(lambda: library_topk(lut2d, onehot, k), PLAIN_REPS, warm=1)
        need(torch.equal(library_topk(lut2d, onehot, k)[0], got[0]),
             f"{name}: the library yardstick's scores disagree at {shape}")
        del onehot
        torch.cuda.empty_cache()
        log(f"[kernels] {name} {shape}: bit-equal to the plain version and "
            "equal to the library's scores")
        # bound: each input read once (codes, LUT), each output written once
        t_bytes = (payload.numel() + lut.numel() + Q * k * 8) / PEAK_BYTES * 1e3
        t_ops = Q * N * m / PEAK_INT32 * 1e3
        out[name] = dict(ms=ms, plain_ms=pm, library_ms=lm,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         shape=shape, bound_formula=(
                             f"max(({payload.numel()} code + {lut.numel()} LUT"
                             f" + {Q * k * 8} out) B / 3.35e12 B/s = "
                             f"{t_bytes:.4f} ms, {Q}*{N}*{m} int32 adds / "
                             f"67e12 /s = {t_ops:.4f} ms)"))
        # pass 1 as the layout runs it: from 5 queries on B4's word kernel
        # and B5's one-hot MMA kernel
        lay = A.adc_layout(k, payload.shape[1], bits, Q, N)
        pass1 = ("adc_split_kernel" if lay.gather else "adc_word_kernel"
                 if lay.word else "adc4_mma_kernel")
        split = device_ms(kern, (pass1, "merge_topk_kernel"))
        log(f"[timing] {name} {shape}: kernel {ms:.4f} ms (median of {REPS}), "
            f"plain {pm:.4f} ms, library {lm:.4f} ms, bound "
            f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}: "
            f"{out[name]['bound_formula']}), roofline "
            f"{out[name]['bound_ms'] / ms:.4f}; device time per call "
            f"(profiler): pass 1 ({pass1}) {split[pass1]:.4f} ms, merge "
            f"{split['merge_topk_kernel']:.4f} ms | {smi()}")
        for qn in (1, 32):
            lq = lut[:qn].contiguous()
            ms1 = time_ms(lambda: K.fused_adc_topk(lq, payload, k,
                                                   packed=packed), REPS)
            b1 = (payload.numel() + lq.numel()) / PEAK_BYTES * 1e3
            o1 = qn * N * m / PEAK_INT32 * 1e3
            log(f"[timing] {name} Q={qn} N={N} M={m} k={k}: kernel {ms1:.4f} "
                f"ms, bound {max(b1, o1):.4f} ms | {smi()}")
        # at the ,r32 arms' scan depth, held bit-equal there
        ms4 = time_ms(lambda: K.fused_adc_topk(lut, payload, 400,
                                               packed=packed), REPS)
        hold_adc(K.fused_adc_topk(lut, payload, 400, packed=packed),
                 adc_plain(lut, payload, 400, packed),
                 f"{name} Q={Q} N={N} M={m} K={kc} k=400")
        log(f"[timing] {name} Q={Q} N={N} M={m} k=400: kernel {ms4:.4f} "
            f"ms; bit-equal to the plain version | {smi()}")
        del lut, codes, payload
    return out


# --------------------------------------------------------------------------
# phase 3 (cont.): the score-matrix kernels B6-B8
# --------------------------------------------------------------------------

QSCORE = {"qmip": "src/repro/kernels/qmip.py:49",
          "ql2": "src/repro/kernels/ql2.py:38",
          "qmip4": "src/repro/kernels/packed.py:99",
          "ql24": "src/repro/kernels/packed.py:114"}
PACKED_QSCORE = ("qmip4", "ql24")


def qscore_plain(name, q, x):
    """The plain version of ``name`` on what ``ops.<name>`` hands its
    kernel: full-width int8 queries against int8 rows, or the query's
    even/odd halves against packed int4 bytes."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import packed as PKD
    from repro_torch.kernels import ql2 as L2K
    from repro_torch.kernels import qmip as IPK

    if name == "qmip":
        return IPK.qmip_plain(q, x)
    if name == "ql2":
        return L2K.ql2_plain(q, x)
    plain = PKD.qmip4_plain if name == "qmip4" else PKD.ql24_plain
    return plain(*K.split_nibble_queries(q), x)


def hold_qscore(name, got, want, tag, err) -> None:
    """B6-B8 against the plain version: bit-equal int32 matrices."""
    import torch

    need(got.dtype == torch.int32 and got.shape == want.shape,
         f"{name}: {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}: {tag}")
    if got.numel():
        err[name] = max(err[name], float((got.long() - want.long()).abs().max()))
    need(torch.equal(got, want), f"{name} differs from the plain version: {tag}")


def check_qscore(err: dict) -> None:
    """B6-B8 against their plain versions at ragged shapes: Q in {1, 37,
    300}, N in {1, 511, 70001}, d in {8, 100, 128, 256} plus an odd d (B6,
    B7: 101) or an odd packed width (B8: d=258, 129 bytes a row); then on
    extreme codes (all -128 / 127, nibbles -8 / 7, alternating), where a
    wrong sign extension, a lost norm or a swapped nibble would show; then
    at the edges of the tensor-core tiling (``qscore_edge_cases``); then
    the extreme pairs at a width where the negated squared L2 wraps in
    int32 (``QSCORE_WRAP``)."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    case = 0
    for name in QSCORE:
        packed = name in PACKED_QSCORE
        lim = 8 if packed else 128
        for Q in (1, 37, 300):
            for N in (1, 511, 70001):
                for d in ((8, 100, 128, 256, 258) if packed
                          else (8, 100, 101, 128, 256)):
                    q = torch.randint(-lim, lim, (Q, d), generator=g,
                                      device=dev).to(torch.int8)
                    x = torch.randint(-lim, lim, (N, d), generator=g,
                                      device=dev).to(torch.int8)
                    xs = PK.pack_int4(x) if packed else x
                    hold_qscore(name, getattr(K, name)(q, xs),
                                qscore_plain(name, q, xs),
                                f"Q={Q} N={N} d={d}", err)
                    case += 1
        lo, hi = -lim, lim - 1
        for d in ((256, 258) if packed else (256, 101)):
            rows = torch.tensor([[lo] * d, [hi] * d, [lo, hi] * (d // 2)
                                 + [lo] * (d % 2)], dtype=torch.int8, device=dev)
            q = rows.repeat(11, 1)                                # Q = 33
            x = torch.cat([rows, torch.zeros((1, d), dtype=torch.int8,
                                             device=dev)]).repeat(17501, 1)
            xs = PK.pack_int4(x) if packed else x
            hold_qscore(name, getattr(K, name)(q, xs), qscore_plain(name, q, xs),
                        f"extreme codes Q=33 N={x.shape[0]} d={d}", err)
            case += 1
        for Q, N, d, offset in qscore_edge_cases(dev):
            if packed and d % 2:
                d += 1
            q = torch.randint(-lim, lim, (Q, d), generator=g,
                              device=dev).to(torch.int8)
            x = torch.randint(-lim, lim, (N + offset, d), generator=g,
                              device=dev).to(torch.int8)
            xs = (PK.pack_int4(x) if packed else x)[offset:]
            need(offset == 0 or xs.data_ptr() % 16 != 0,
                 f"{name}: the view at offset {offset} is 16-byte aligned")
            hold_qscore(name, getattr(K, name)(q, xs), qscore_plain(name, q, xs),
                        f"edge Q={Q} N={N} d={d} offset={offset}", err)
            case += 1
        d = QSCORE_WRAP[name]
        q = torch.tensor([[-128] * d, [127] * d], dtype=torch.int8, device=dev)
        x = torch.tensor([[lo] * d, [0] * d, [hi] * d], dtype=torch.int8,
                         device=dev)
        xs = PK.pack_int4(x) if packed else x
        want = qscore_plain(name, q, xs)
        need(name in ("qmip", "qmip4") or int(want[0, 2]) > 0,
             f"{name}: the wrap-around case did not wrap at d={d}")
        hold_qscore(name, getattr(K, name)(q, xs), want,
                    f"wrap-around Q=2 N=3 d={d}", err)
        case += 1
    torch.cuda.synchronize()
    log(f"[kernels] {case} score-matrix cases (B6-B8) bit-equal to the plain "
        "versions, extreme codes, the tensor-core tiling's edges, packed "
        "rows' pad bytes and int32 wrap-around included")


#: widths at which -(|q|^2 + |x|^2 - 2 q . x) of the extreme pairs passes
#: 2^31: (-128 - 127)^2 d for int8 rows, (-128 - 7)^2 d for int8 queries
#: against int4 nibbles (run for B6 / B8a too)
QSCORE_WRAP = {"qmip": 33_040, "ql2": 33_040, "qmip4": 117_840,
               "ql24": 117_840}


def qscore_edge_cases(dev) -> list:
    """(Q, N, d, offset) at the edges of the tensor-core kernel's tiling,
    which all four ops share: Q at each query-tile boundary; N at and just
    past the corpus tile and k times the SM count of tiles (the persistent
    stride at k blocks an SM), odd N leaving output rows unaligned; d =
    31 ... 34; rows of 17, 50, 51 and 129 bytes when packed (d = 34, 100,
    102, 258: B8b's pad bytes past the row are not a multiple of its
    64-byte chunk), each also as a corpus view at an unaligned base
    (``x[offset:]`` of an [N + 1, d] buffer)."""
    import torch

    from repro_torch.kernels import _qscore

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(q, 1000, 128, 0) for q in (1, 7, 8, 9, 16, 17, 64, 65, 128, 129)]
    for q in (1, 100):
        bm = _qscore.mma_tiles(q)[1]
        cases += [(q, k * bm + p, 64, 0) for k in (1, sms, 2 * sms)
                  for p in (0, 1)]
    cases += [(5, 333, d, 0) for d in (31, 32, 33, 34)]
    return cases + [(9, 1000, 2 * w, off) for w in (17, 50, 51, 129)
                    for off in (0, 1)]


def time_qscore(err: dict) -> dict:
    """B6-B8 at the retrieval shapes: a 1,000,000 x 128 int8 candidate
    table (B8: its packed int4 form), Q=512 (the serve_p99 batch; B6 and
    B7 also Q=1, the retrieval_cand batch).  Each result is held against
    the plain version's and the library yardstick's: ``torch._int_mm``
    (int8 tensor cores, exact int32; it needs more than 16 rows, so Q=1 is
    padded to 32 query rows), for B7 / B8b with the two norm vectors and
    the combine inside the clock; for B8 over the unpacked int8 corpus,
    built before the clock.  Each kernel and its yardstick are timed
    alike, before any plain version."""
    import torch

    from repro_torch.core import pack as PK
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    N, d = 1_000_000, 128
    x = torch.randint(-128, 128, (N, d), generator=g, device=dev).to(torch.int8)
    x4 = torch.randint(-8, 8, (N, d), generator=g, device=dev).to(torch.int8)
    px = PK.pack_int4(x4)

    def lib_l2(q, xc):
        qq = (q.int() ** 2).sum(1, dtype=torch.int32)
        xx = (xc.int() ** 2).sum(1, dtype=torch.int32)
        return -(qq[:, None] + xx[None, :] - 2 * torch._int_mm(q, xc.T))

    runs = []
    for name in QSCORE:
        packed = name in PACKED_QSCORE
        lim = 8 if packed else 128
        for Q in ((512,) if packed else (1, 512)):
            runs.append((name, packed, Q, torch.randint(
                -lim, lim, (Q, d), generator=g, device=dev).to(torch.int8)))

    def operands(name, packed, Q, q):
        xs, xc = (px, x4) if packed else (x, x)
        qp = torch.nn.functional.pad(q, (0, 0, 0, 32 - Q)) if Q < 32 else q
        if name in ("qmip", "qmip4"):
            return xs, lambda: torch._int_mm(qp, xc.T)
        return xs, lambda: lib_l2(qp, xc)

    # each kernel and its yardstick alike (2 warm calls, median of REPS)
    # before any plain version: right after the plain float64 products of
    # the op before it, a kernel reads slow for a while
    kern_ms, lib_ms = {}, {}
    for name, packed, Q, q in runs:
        xs, lib = operands(name, packed, Q, q)
        kern_ms[name, Q] = time_ms(lambda: getattr(K, name)(q, xs), REPS)
        lib_ms[name, Q] = time_ms(lib, REPS)
    out = {}
    for name, packed, Q, q in runs:
        xs, lib = operands(name, packed, Q, q)
        ms, lm = kern_ms[name, Q], lib_ms[name, Q]
        pm = time_ms(lambda: qscore_plain(name, q, xs), PLAIN_REPS, warm=1)
        shape = f"Q={Q} N={N} d={d}" + (" packed int4" if packed else "")
        got = getattr(K, name)(q, xs)
        hold_qscore(name, got, qscore_plain(name, q, xs), shape, err)
        need(torch.equal(lib()[:Q], got),
             f"{name}: the library yardstick disagrees at {shape}")
        q_bytes, x_bytes, o_bytes = Q * d, N * xs.shape[1], Q * N * 4
        t_bytes = (q_bytes + x_bytes + o_bytes) / PEAK_BYTES * 1e3
        t_ops = 2.0 * Q * N * d / PEAK_INT8 * 1e3
        rec = dict(ms=ms, plain_ms=pm, library_ms=lm,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   shape=shape, bound_formula=(
                       f"max(({q_bytes} q + {x_bytes} x + {o_bytes} out) B"
                       f" / 3.35e12 B/s = {t_bytes:.4f} ms, 2*{Q}*{N}*{d}"
                       f" ops / 1.979e15 /s = {t_ops:.4f} ms)"))
        log(f"[timing] {name} {shape}: kernel {ms:.4f} ms and library "
            f"{lm:.4f} ms (medians of {REPS}), plain {pm:.4f} ms"
            f"{' (Q padded to 32)' if Q < 32 else ''}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{rec['bound_formula']}), roofline {rec['bound_ms'] / ms:.4f}"
            f"; bit-equal to the plain version and the library | {smi()}")
        if Q == 512:                    # the kernels line: the batched shape
            out[name] = rec
        del got
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 4: the main path at full width
# --------------------------------------------------------------------------

def serve(index, queries, k, sizes, searcher=None):
    """Run ``queries`` through a Searcher in requests of ``sizes`` (cycled);
    returns (ids, QPS, p50 ms, searcher)."""
    import torch

    s = searcher or index.searcher(k, batch_sizes=BUCKETS)
    for b in BUCKETS:                               # warm every bucket
        s(queries[:b])
    torch.cuda.synchronize()
    lat, ids, start, j = [], [], 0, 0
    t0 = time.perf_counter()
    while start < queries.shape[0]:
        b = sizes[j % len(sizes)]
        j += 1
        t = time.perf_counter()
        res = s(queries[start:start + b])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        ids.append(res.ids)
        start += b
    total = time.perf_counter() - t0
    return torch.cat(ids), queries.shape[0] / total, statistics.median(lat), s


def check_scan(f, idx, queries, depth, err) -> None:
    """One arm's scan kernel against its plain version at every Searcher
    bucket and the arm's scan depth, full size (launches here come after
    the main path's counts were read)."""
    import torch

    from repro_torch.engine import PQStore
    from repro_torch.engine.scorer import _prepare_pq_lut
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K

    store = idx.store
    if isinstance(store, PQStore):
        name = "fused_adc4" if store.packed else "fused_adc"
        for b in BUCKETS:
            lut = _prepare_pq_lut(queries[:b], store, idx.metric)
            need(lut.dtype == torch.int8, f"{f}: the ADC kernels take int8 LUTs")
            got = K.fused_adc_topk(lut, store.codes, depth, packed=store.packed)
            want = adc_plain(lut, store.codes, depth, store.packed)
            hold_adc(got, want, f"{f} Q={b} k={depth}")
        log(f"[main] {f}: {name} at N={store.n}, Q in {BUCKETS}, k={depth} "
            "bit-equal to the plain version given the same int8 LUT")
        return
    name = KERNEL_OF["int4" if store.packed else
                     "int8" if store.quantized else "fp32"]
    swaps = 0
    for b in BUCKETS:
        q = store.encode_queries(queries[:b])
        got = K.fused_topk(q, store.data, depth, idx.metric,
                           packed=store.packed)
        if store.packed:
            qe, qo = K.split_nibble_queries(q)
            want = F.fused_topk4_plain(qe, qo, store.data, k=depth,
                                       metric=idx.metric)
        else:
            want = F.fused_topk_plain(q, store.data, k=depth,
                                      metric=idx.metric)
        swaps += hold(name, got, want, q, store.data, depth, idx.metric,
                      None, f"{f} Q={b} k={depth}", err)
    agree = ("bit-equal to" if name != "fused_topk_fp32" else
             f"within rtol 1e-5 of (near-tie id swaps: {swaps})")
    log(f"[main] {f}: {name} at N={store.n}, Q in {BUCKETS}, k={depth} "
        f"{agree} the plain version")


def request_parts(f, idx, queries, k, rerank) -> None:
    """Where one 256-query request's time goes: the query-side work (Eq. 1
    encode, or the ADC LUT build and int8 quantization), the scan at the
    arm's depth, and the rerank tail; CUDA-event medians, after the main
    path's counts were read."""
    from repro_torch import engine
    from repro_torch.engine import PQStore
    from repro_torch.engine.scorer import _prepare_pq_lut, _topk_pq_from_lut

    q = queries[:256]
    store = idx.store
    depth = rerank.depth if rerank is not None else k
    if isinstance(store, PQStore):
        prep = ("LUT build", lambda: _prepare_pq_lut(q, store, idx.metric))
        lut = prep[1]()
        scan = lambda: _topk_pq_from_lut(lut, store, depth, idx.metric, 16384)
    else:
        prep = ("encode", lambda: store.encode_queries(q))
        qc = prep[1]()
        scan = lambda: engine.topk(qc, store, depth, idx.metric, prepared=True)
    parts = {prep[0]: time_ms(prep[1], 5), f"scan k={depth}": time_ms(scan, 5)}
    if rerank is not None:
        ids = scan()[1]
        parts["rerank"] = time_ms(lambda: engine.rerank_among(
            q, rerank.store, ids, k, idx.metric), 5)
    log(f"[main] {f}: one 256-query request's parts (CUDA events, median of "
        f"5): " + ", ".join(f"{n} {t:.3f} ms" for n, t in parts.items())
        + f" | {smi()}")


def pq_memory(idx, n: int, d: int) -> int:
    """The reference's PQ memory formula: code bytes + codebooks as f32,
    plus the rerank store."""
    m, kc = idx.m, 2 ** idx.bits
    total = n * (-(-m // 2) if idx.bits == 4 else m) + m * kc * (d // m) * 4
    if idx.rerank_store is not None:
        total += n * d * 4 if idx.rerank_store.bits == 32 else n * d + 3 * d * 4
    return total


def main_path(err: dict) -> dict:
    """Each corpus is one run of the main path: counters set to 0 before
    it, read after it; the kernel-versus-plain checks of that corpus's arms
    follow, and its tensors are freed before the next corpus."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.engine import CodeStore, PQStore
    from repro_torch.kernels import ref as R
    from repro_torch.knn import make_index

    card = smi()
    k = 100
    sizes = {"product": (4_000_000, 256), "sift": (1_000_000, 128),
             "glove": (1_183_514, 100)}
    arms = {"product": ["flat,lpq8@gaussian:3", "flat,lpq4", "flat,lpq4+r32",
                        "pq32+lpq", "pq64x4+lpq", "pq64x4+lpq,r32"],
            "sift": ["flat,lpq8@global_minmax", "pq16+lpq", "pq16"],
            "glove": ["flat,lpq8@global_absmax"]}
    counts = dict.fromkeys(kernels.launch_counts(), 0)
    for name, (n, d) in sizes.items():
        corpus, queries, metric = synthetic.load(name, n, 1000)
        assert corpus.shape == (n, d)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        flat = make_index("flat", corpus, metric=metric)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gt, qps, p50, _ = serve(flat, queries, k, (256,))
        log(f"[main] {name} {n}x{d} {metric} flat: recall@100 1.0000 mem 1.000 "
            f"QPS {qps:.1f} p50 {p50:.2f} ms (256-query requests) build "
            f"{build_s:.2f} s | {card}")
        checks, parts = [], []
        if metric != "angular":
            checks.append((f"{name} flat", flat, queries, k))
        for f in arms[name]:
            t0 = time.perf_counter()
            idx = make_index(f, corpus, metric=metric)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            ids, qps, p50, srch = serve(idx, queries, k, (256,))
            if isinstance(idx.store, PQStore):
                need(idx.memory_bytes() == pq_memory(idx, n, d),
                     f"{f}: memory {idx.memory_bytes()} is not the reference's "
                     f"formula's {pq_memory(idx, n, d)}")
            else:
                # B1 at full size: the stored codes are the plain version's
                p = idx.store.params
                plain = CodeStore.from_codes(
                    R.quantize_ref(corpus, p.lo, p.hi, p.zero, bits=p.bits), p,
                    pack=idx.store.packed).data
                need(torch.equal(plain, idx.store.data),
                     f"{f}: corpus codes differ from the plain quantize")
            rec = recall_at_k(gt, ids)
            ratio = idx.memory_bytes() / flat.memory_bytes()
            need(ids.shape == (1000, k) and bool(torch.all(ids >= 0)),
                 f"{f}: bad ids")
            mixed = ""
            if name == "product":
                _, mqps, mp50, _ = serve(idx, queries[:205], k, (1, 8, 32), srch)
                mixed = f"; mixed 1/8/32: QPS {mqps:.1f} p50 {mp50:.2f} ms"
            log(f"[main] {name} {n}x{d} {metric} {f}: recall@100 {rec:.4f} mem "
                f"{ratio:.4f} QPS {qps:.1f} p50 {p50:.2f} ms (256-query "
                f"requests){mixed} build {build_s:.2f} s | {card}")
            fp32_lut = isinstance(idx.store, PQStore) and not idx.store.lpq_tables
            if metric != "angular" and not fp32_lut:
                # the scan depth the Searcher asks for (+r32: the rerank depth)
                depth = srch.rerank.depth if srch.rerank is not None else k
                checks.append((f, idx, queries, depth))
            if f.startswith("pq") or srch.rerank is not None:
                parts.append((f, idx, queries, k, srch.rerank))
            del idx, srch
        run = kernels.launch_counts()
        log(f"[main] {name}: kernel launches on this run of the main path: {run}")
        for kname, c in run.items():
            counts[kname] += c
        while parts:
            request_parts(*parts.pop(0))
        while checks:
            check_scan(*checks.pop(0), err)
        del flat, corpus, queries, gt
        torch.cuda.empty_cache()
    counts = {kname: counts[kname] for kname in MAIN_KERNELS}
    log(f"[main] kernel launches on the main path: {counts}")
    for kname, c in counts.items():
        need(c > 0, f"kernel {kname} was never launched on the main path")
    return counts


# --------------------------------------------------------------------------
# phase 6: recsys candidate retrieval at full width (retrieval_cand)
# --------------------------------------------------------------------------

def retrieval_data(n: int, d: int, n_queries: int, seed: int):
    """Candidate table and queries in the reference's ``table_init``
    distribution, N(0, 1) * d^-1/2, drawn with numpy (as
    scripts/recsys_reference_recall.py draws them)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scale = np.float32(d ** -0.5)
    table = rng.standard_normal((n, d), dtype=np.float32) * scale
    queries = rng.standard_normal((n_queries, d), dtype=np.float32) * scale
    return table, queries


def keyed_top_k(s, k):
    """The alternative top-k (timed only): one ``torch.topk`` over unique
    int64 keys, the score's order key above ``N - 1 - column``."""
    import torch

    from repro_torch.kernels import ref as R

    n = s.shape[1]
    key = R.order_key(s).to(torch.int64)
    key.bitwise_left_shift_(32)
    key.bitwise_or_(torch.arange(n - 1, -1, -1, device=s.device))
    ids = (n - 1) - (torch.topk(key, k, dim=1).values & 0xFFFFFFFF)
    return torch.gather(s, 1, ids), ids.to(torch.int32)


def serve_retrieval(step, args, queries, batch):
    """``queries`` through ``step`` in requests of ``batch``; returns
    ([n, k] scores, [n, k] ids, QPS, p50 ms)."""
    import torch

    out_s, out_i, lat = [], [], []
    t0 = time.perf_counter()
    for s0 in range(0, queries.shape[0], batch):
        t = time.perf_counter()
        s, i = step(queries[s0:s0 + batch], *args)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        out_s.append(s)
        out_i.append(i)
    total = time.perf_counter() - t0
    return (torch.cat(out_s), torch.cat(out_i), queries.shape[0] / total,
            statistics.median(lat))


def retrieval_path(err: dict) -> dict:
    """DLRM-MLPerf ``retrieval_cand`` at full width: 1,000,000 candidates x
    embed_dim 128, k=100, one run of the path with the launch counters set
    to 0 before it and read after: ``QuantizedTable.from_dense`` (abs-max
    Eq. 1), then ``make_retrieval(True)`` (B1 + B6) and
    ``make_retrieval(False)`` (fp32) serving single-query requests (the
    retrieval_cand batch) and 512-query requests (the serve_p99 batch).
    Then: one B1 and one B6 launch per quantized request, the memory ratio
    against the reference's formula, ids and scores equal to the plain
    path's (plain B1, plain B6, the stable-sort top-k of ``ref.topk_ref``),
    recall@100 of the int8 arm against the fp32 arm, and each request's
    parts by CUDA events."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import base as CB
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import qmip as IPK
    from repro_torch.kernels import ref as R
    from repro_torch.launch import make_retrieval
    from repro_torch.models.recsys.embedding import QuantizedTable
    from repro_torch.models.recsys.retrieval import top_k

    card = smi()
    dev = torch.device("cuda")
    d = dlrm_mlperf.config().embed_dim
    n = CB.RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    b_one = CB.RECSYS_SHAPES["retrieval_cand"]["batch"]
    b_many = CB.RECSYS_SHAPES["serve_p99"]["batch"]
    k, n_one, n_many = 100, 200, 4 * b_many
    table_np, queries_np = retrieval_data(n, d, n_many, seed=0)
    table = torch.from_numpy(table_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    del table_np, queries_np

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    qt = QuantizedTable.from_dense(table)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    p = qt.params
    step8, step32 = make_retrieval(True, k=k), make_retrieval(False, k=k)
    args8, args32 = (qt.codes, p.lo, p.hi, p.zero), (table,)
    res = {}
    n_quant = 0
    for batch, nq in ((b_one, n_one), (b_many, n_many)):
        for arm, step, args in (("int8", step8, args8), ("fp32", step32, args32)):
            for _ in range(2):                              # warm-up requests
                step(queries[:batch], *args)
            n_quant += 2 * (arm == "int8")
            res[arm, batch] = serve_retrieval(step, args, queries[:nq], batch)
            n_quant += (nq // batch) * (arm == "int8")
    run = kernels.launch_counts()
    log(f"[retrieval] kernel launches on this run of the path: {run} "
        f"({n_quant} quantized requests)")
    need(run["quantize"] == n_quant and run["qmip"] == n_quant,
         f"retrieval: expected one B1 and one B6 launch per quantized request "
         f"({n_quant}), got {run}")
    need(all(c == 0 for name, c in run.items() if name not in ("quantize", "qmip")),
         f"retrieval: a kernel off the path was launched: {run}")

    mem = qt.memory_bytes()
    want_mem = n * d + 3 * d * 4
    ratio = mem / (table.numel() * 4)
    need(mem == want_mem, f"retrieval: memory {mem} is not the reference's "
         f"formula's {want_mem}")
    s8, i8, _, _ = res["int8", b_many]
    _, i32, _, _ = res["fp32", b_many]
    need(i8.shape == (n_many, k) and bool(torch.all((i8 >= 0) & (i8 < n))),
         "retrieval: bad int8 ids")
    need(bool(torch.all(torch.isfinite(s8))), "retrieval: non-finite scores")
    need(torch.equal(res["int8", b_one][1], i8[:n_one]) and
         torch.equal(res["int8", b_one][0], s8[:n_one]),
         "retrieval: a query's int8 result depends on its batch")
    rec = recall_at_k(i32, i8)
    rec1 = recall_at_k(res["fp32", b_one][1], res["int8", b_one][1])
    for (arm, batch), (_, _, qps, p50) in res.items():
        log(f"[retrieval] {n}x{d} {arm} Q={batch}: QPS {qps:.1f} p50 {p50:.3f} "
            f"ms | {card}")
    log(f"[retrieval] recall@100 int8 vs fp32: {rec:.4f} over {n_many} queries "
        f"(Q={b_many} requests), {rec1:.4f} over {n_one} (Q=1); memory ratio "
        f"{ratio:.4f} ({mem} B, the reference's (N*d + 3*d*4) / (4*N*d)); "
        f"QuantizedTable.from_dense {build_s:.2f} s")

    # the plain path on the same codes: plain B1, plain B6, stable-sort top-k
    for j in range(8):                                    # Q=1 requests, CPU sort
        qc = R.quantize_ref(queries[j:j + 1], p.lo, p.hi, p.zero, bits=p.bits)
        ws, wi = R.topk_ref(IPK.qmip_plain(qc, qt.codes).float().cpu(), k)
        gs, gi = res["int8", b_one][0][j:j + 1], res["int8", b_one][1][j:j + 1]
        need(torch.equal(gi.cpu(), wi) and torch.equal(gs.cpu(), ws),
             f"retrieval: Q=1 request {j} differs from the plain path")
    qc = R.quantize_ref(queries[:b_many], p.lo, p.hi, p.zero, bits=p.bits)
    plain_s = IPK.qmip_plain(qc, qt.codes)
    hold_qscore("qmip", K.qmip(qc, qt.codes), plain_s,
                f"retrieval Q={b_many} N={n} d={d}", err)
    ws, wi = R.topk_ref(plain_s.float(), k)
    need(torch.equal(wi, i8[:b_many]) and torch.equal(ws, s8[:b_many]),
         f"retrieval: the Q={b_many} request differs from the plain path")
    log(f"[retrieval] ids and scores equal the plain path's (plain B1, B6 and "
        f"the stable-sort top-k): 8 Q=1 requests (sorted on the CPU) and one "
        f"Q={b_many} request")
    del plain_s, ws, wi

    # where a request's time goes (after the counts were read)
    parts = {}
    for batch in (b_one, b_many):
        q = queries[:batch]
        qc = K.quantize(q, p.lo, p.hi, p.zero, bits=p.bits)
        s = K.qmip(qc, qt.codes)
        sf = s.float()
        f32 = q @ table.T
        parts[batch] = {
            "B1 quantize": time_ms(lambda: K.quantize(q, p.lo, p.hi, p.zero,
                                                      bits=p.bits), REPS),
            "B6 qmip": time_ms(lambda: K.qmip(qc, qt.codes), REPS),
            "cast + top-k": time_ms(lambda: top_k(s.float(), k), REPS),
            "int64-key top-k (not used)": time_ms(lambda: keyed_top_k(sf, k),
                                                  PLAIN_REPS),
            "fp32 matmul": time_ms(lambda: q @ table.T, REPS),
            "fp32 top-k": time_ms(lambda: top_k(f32, k), REPS),
        }
        need(torch.equal(keyed_top_k(sf, k)[1], top_k(sf, k)[1]),
             "retrieval: the two top-k forms disagree")
        log(f"[retrieval] one Q={batch} request's parts (CUDA events, median): "
            + ", ".join(f"{name} {t:.4f} ms" for name, t in parts[batch].items())
            + f" | {card}")
        del s, sf, f32
    del qt, table, queries
    torch.cuda.empty_cache()
    return run


def ops_path() -> dict:
    """The public score-matrix ops as their callers use them (the
    reference's ``bench_kernels`` and engine tests): ``ops.qmip`` /
    ``ops.ql2`` over the int8 codes and ``ops.qmip4`` / ``ops.ql24`` over
    the packed int4 codes of a 1,000,000 x 128 table, one 512-query batch;
    one run with the counters set to 0 before it and read after."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import pack as PK
    from repro_torch.kernels import ops as K
    from repro_torch.models.recsys.embedding import QuantizedTable

    table_np, queries_np = retrieval_data(1_000_000, 128, 512, seed=1)
    table = torch.from_numpy(table_np).cuda()
    queries = torch.from_numpy(queries_np).cuda()
    q8, q4 = (QuantizedTable.from_dense(table, bits=b) for b in (8, 4))
    packed = PK.pack_int4(q4.codes)
    qc8 = K.quantize(queries, q8.params.lo, q8.params.hi, q8.params.zero)
    qc4 = K.quantize(queries, q4.params.lo, q4.params.hi, q4.params.zero, bits=4)
    kernels.reset_launch_counts()
    outs = [K.qmip(qc8, q8.codes), K.ql2(qc8, q8.codes),
            K.qmip4(qc4, packed), K.ql24(qc4, packed)]
    torch.cuda.synchronize()
    run = kernels.launch_counts()
    log(f"[ops] kernel launches on this run of the score-matrix ops: {run}")
    for name in QSCORE:
        need(run[name] == 1, f"ops: {name} launched {run[name]} times, not once")
    for o in outs:
        need(o.shape == (512, 1_000_000) and o.dtype == torch.int32,
             "ops: bad score matrix")
    need(bool(torch.all(outs[1] <= 0)) and bool(torch.all(outs[3] <= 0)),
         "ops: a negated squared distance is positive")
    del outs, table, queries, q8, q4, packed
    torch.cuda.empty_cache()
    return run


def retrieval_recall() -> None:
    """The card's int8-vs-fp32 recall@100 at n=20000, d=128, 128 queries,
    within 0.01 of the reference's on the same numpy inputs."""
    import torch

    from repro_torch.core.preserve import recall_at_k
    from repro_torch.launch import make_retrieval
    from repro_torch.models.recsys.embedding import QuantizedTable

    table_np, queries_np = retrieval_data(20000, 128, 128, seed=0)
    table = torch.from_numpy(table_np).cuda()
    queries = torch.from_numpy(queries_np).cuda()
    qt = QuantizedTable.from_dense(table)
    p = qt.params
    _, i8 = make_retrieval(True)(queries, qt.codes, p.lo, p.hi, p.zero)
    _, i32 = make_retrieval(False)(queries, table)
    rec = recall_at_k(i32, i8)
    ok = abs(rec - REF_RETRIEVAL_RECALL) <= 0.01
    log(f"[retrieval] n=20000 d=128 128 queries: recall@100 {rec:.4f} "
        f"(reference {REF_RETRIEVAL_RECALL}, |diff| <= 0.01: {ok}) | {smi()}")
    need(ok, f"retrieval recall {rec:.4f} vs the reference's "
         f"{REF_RETRIEVAL_RECALL}")


# --------------------------------------------------------------------------
# phase 7: the graph walk and HNSW (the paper's hnsw32,lpq8@gaussian:3 arm)
# --------------------------------------------------------------------------

#: phase 7(a): integer arms (factory, metric) built and searched on the card
#: and on the CPU from the same levels, held bit-equal
GRAPH_EXACT = (("hnsw8,lpq8@gaussian:3", "ip"), ("hnsw8,lpq8", "l2"),
               ("hnsw8,lpq8@global_absmax", "angular"), ("hnsw8,lpq4", "ip"))
#: the paper's arm and its fp32 pair (src/repro/configs/lpq_ann.py:24),
#: built with Table 1's batch and paper section 5.2's smallest EFC and M
GRAPH_ARMS = ("hnsw32,lpq8@gaussian:3", "hnsw32")
GRAPH_BUILD = {"ef_construction": 300, "batch_size": 256}
GRAPH_EF = (300, 800)
#: phase 7(c)'s product-like rows.  The build is the reference's host-side,
#: point-by-point commit (src/repro/knn/hnsw.py:149-204), which the port
#: copies, beside a walk of some 50 small launches a step: one 100,000-row
#: int8 build took 250-264 s on the H100 (scripts/hnsw_probe.py), one
#: 50,000-row build 110-120 s and one 20,000-row build 43-45 s.  At
#: 50,000 rows phase 7 took 472 of the script's 1,011 s; 20,000 rows make
#: room for phase 10 inside the 1200 s limit.  7(b) checks its recall on
#: 7(c)'s builds, so GRAPH_N is also REF_HNSW's size
GRAPH_N = 20_000

#: the reference's HNSW recall@100 at n=20000 x 256 product-like, 128
#: queries, ef_construction 300, batch 256: (mean, spread = max - min) over
#: three seeds of data and levels, at each ef_search, measured on the CPU
#: by scripts/hnsw_reference_recall.py
REF_HNSW = {
    ("hnsw32,lpq8@gaussian:3", 300): (0.9015, 0.0049),
    ("hnsw32,lpq8@gaussian:3", 800): (0.9798, 0.0020),
    ("hnsw32", 300): (0.9024, 0.0042),
    ("hnsw32", 800): (0.9929, 0.0017),
}


def hnsw_memory(idx, n: int, d: int) -> int:
    """The reference's HNSW memory formula (src/repro/knn/hnsw.py:373-382):
    the store (int8 codes + Eq. 1 constants, or fp32 rows) plus 4 bytes a
    slot of every dense layer, [N, 2m] at layer 0 and [N, m] above."""
    store = n * d + 3 * d * 4 if idx.quantized else n * d * 4
    return store + 4 * n * (2 * idx.m + (len(idx.layers) - 1) * idx.m)


def graph_exact() -> None:
    """7(a): each integer arm built on the card and on the CPU from the same
    inputs (the port's own levels, Eq. 1 constants learned once on the
    CPU: each device's reductions round the corpus statistics their own
    way) has the same codes, the same adjacency, layer for layer, and the
    same entry; a Searcher with buckets (1, 8, 32, 256) returns the same
    ids and scores on both devices for 256 queries (requests of 1, 8, 32
    and 215, one a bucket) at ef_search 40 and 80.  The fp32 arm: the
    card's recall@10 within 0.01 of the CPU's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.preserve import recall_at_k
    from repro_torch.knn import SearchParams, as_spec, make_index
    from repro_torch.knn.hnsw import HNSWIndex, draw_levels

    n, d = 4000, 64
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((256, d)).astype(np.float32)
    levels = draw_levels(n, 8, 0)

    def build(f, metric, dev):
        spec = as_spec(f, metric=metric)
        if spec.quant is not None:
            qp = spec.quant.learn(torch.from_numpy(corpus))
            spec = dataclasses.replace(spec, quant=spec.quant.with_params(qp))
        return HNSWIndex.build(corpus, spec, device=dev, ef_construction=40,
                               batch_size=128, _levels=levels)

    def requests(idx, ef):
        s = idx.searcher(10, SearchParams(ef_search=ef), batch_sizes=BUCKETS)
        out, start = [], 0
        for b in (1, 8, 32, 215):
            out.append(s(queries[start:start + b]))
            start += b
        return (torch.cat([r.scores.cpu() for r in out]),
                torch.cat([r.ids.cpu() for r in out]))

    # why one set of constants: the card's reductions round them otherwise
    quant = as_spec(GRAPH_EXACT[0][0]).quant
    x = torch.from_numpy(corpus)
    own = [quant.learn(x.to(dev)) for dev in ("cuda", "cpu")]
    consts = sum(int(torch.sum(getattr(own[0], a).cpu() != getattr(own[1], a)))
                 for a in ("lo", "hi", "zero"))
    codes = int(torch.sum(quant.encode(x.cuda(), own[0]).cpu()
                          != quant.encode(x, own[1])))
    log(f"[graph] {GRAPH_EXACT[0][0]} {n}x{d}: Eq. 1 constants learned on "
        f"the card differ from the CPU's in {consts} of {3 * d} values, the "
        f"codes in {codes} of {n * d}")
    for f, metric in GRAPH_EXACT:
        t0 = time.perf_counter()
        card = build(f, metric, "cuda")
        card_s = time.perf_counter() - t0
        cpu = build(f, metric, "cpu")
        need(torch.equal(card.store.data.cpu(), cpu.store.data),
             f"{f} {metric}: the card's codes differ from the CPU's")
        need(len(card.layers) == len(cpu.layers) and all(
            torch.equal(a.cpu(), b) for a, b in zip(card.layers, cpu.layers)),
            f"{f} {metric}: the card's adjacency differs from the CPU's")
        need(card.entry == cpu.entry, f"{f} {metric}: entry differs")
        for ef in (40, 80):
            (sa, ia), (sb, ib) = requests(card, ef), requests(cpu, ef)
            need(torch.equal(ia, ib) and torch.equal(sa, sb),
                 f"{f} {metric} ef_search {ef}: the card's results differ "
                 "from the CPU's")
        log(f"[graph] {f} {metric} {n}x{d}: {len(card.layers)} layers, "
            f"adjacency and entry equal to the CPU build's; Searcher ids and "
            f"scores equal at ef_search 40 and 80 (card build "
            f"{card_s:.2f} s)")
    gt = make_index("flat", corpus, device="cpu").search(queries, 10).ids
    rec = {dev: recall_at_k(gt, requests(build("hnsw8", "ip", dev), 40)[1])
           for dev in ("cuda", "cpu")}
    ok = abs(rec["cuda"] - rec["cpu"]) <= 0.01
    log(f"[graph] hnsw8 ip (fp32) {n}x{d}: recall@10 card {rec['cuda']:.4f} "
        f"CPU {rec['cpu']:.4f} (|diff| <= 0.01: {ok})")
    need(ok, f"hnsw8: card recall {rec['cuda']:.4f} vs CPU {rec['cpu']:.4f}")


def graph_recall(built: dict) -> None:
    """7(b): the paper's arm and its fp32 pair as 7(c) built them
    (``built``: factory -> index, the build the reference's script makes at
    n=20000 x 256 product-like), 128 queries: recall@100 against the fp32
    flat arm at each ef_search within max(0.02, the reference's spread) of
    the reference's mean (REF_HNSW)."""
    import torch

    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.knn import SearchParams, make_index

    corpus, queries, metric = synthetic.load("product", 20000, 128)
    need(torch.equal(built["hnsw32"].store.data, corpus),
         "7(b): 7(c)'s fp32 build holds other rows than REF_HNSW's corpus")
    gt = make_index("flat", corpus, metric=metric).search(queries, 100).ids
    for f in GRAPH_ARMS:
        idx = built[f]
        for ef in GRAPH_EF:
            s = idx.searcher(100, SearchParams(ef_search=ef))
            rec = recall_at_k(gt, s(queries).ids)
            want, spread = REF_HNSW[f, ef]
            tol = max(0.02, spread)
            ok = abs(rec - want) <= tol
            log(f"[graph] product 20000x256 {metric} {f} ef_search {ef}: "
                f"recall@100 {rec:.4f} (reference mean {want}, spread "
                f"{spread}, |diff| <= {tol}: {ok}) | {smi()}")
            need(ok, f"HNSW recall for {f} at ef_search {ef}: {rec:.4f} vs "
                 f"{want} +- {tol}")


def walk_request(searcher, queries, profiled: bool):
    """One request's walk: its layer-0 and upper-layer steps and per-query
    iterations (``graph.STEPS``), its B1 launches, and, when ``profiled``,
    the CUDA kernels a step from a torch.profiler trace of it (device
    kernel records, or the host's launch calls where the trace holds no
    device record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.knn import graph as G

    before = kernels.launch_counts()["quantize"]
    G.reset_steps()
    if not profiled:
        searcher(queries)
        torch.cuda.synchronize()
        return dict(G.STEPS), kernels.launch_counts()["quantize"] - before, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        searcher(queries)
        torch.cuda.synchronize()
    steps = dict(G.STEPS)
    events = prof.events()
    launched = sum(1 for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if launched == 0:
        launched = sum(1 for e in events if e.name.startswith("cudaLaunch"))
    per_step = launched / max(steps["beam"] + steps["greedy"], 1)
    return steps, kernels.launch_counts()["quantize"] - before, per_step


def graph_path() -> dict:
    """7(c): the paper's arm and its fp32 pair at GRAPH_N x 256
    product-like through make_index + Searcher, one run of the path with the
    launch counters set to 0 before it and read after: build seconds, the
    memory ratio (against the reference's formula, over the fp32 graph and
    over fp32 flat), recall@100 against the fp32 flat arm, QPS and p50 at
    256-query requests and for the mixed 1/8/32 stream at each ef_search.
    Then, per arm and ef_search, one 256-query request's walk: layer-0
    steps, iterations a query, B1 launches, and (at the first ef_search,
    under torch.profiler) kernels a step.  Last, 7(b) on these builds."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.knn import SearchParams, make_index

    card = smi()
    n, k = GRAPH_N, 100
    corpus, queries, metric = synthetic.load("product", n, 1000)
    d = corpus.shape[1]
    gt = make_index("flat", corpus, metric=metric).search(queries, k).ids
    kernels.reset_launch_counts()
    built, mem = {}, {}
    for f in GRAPH_ARMS:
        t0 = time.perf_counter()
        idx = make_index(f, corpus, metric=metric, **GRAPH_BUILD)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mem[f] = idx.memory_bytes()
        need(mem[f] == hnsw_memory(idx, n, d),
             f"{f}: memory {mem[f]} is not the reference's formula's "
             f"{hnsw_memory(idx, n, d)}")
        for ef in GRAPH_EF:
            s = idx.searcher(k, SearchParams(ef_search=ef))
            ids, qps, p50, _ = serve(idx, queries, k, (256,), s)
            need(ids.shape == (1000, k) and bool(torch.all(ids >= 0)),
                 f"{f}: bad ids")
            rec = recall_at_k(gt, ids)
            _, mqps, mp50, _ = serve(idx, queries[:205], k, (1, 8, 32), s)
            log(f"[graph] product {n}x{d} {metric} {f} ef_search {ef}: "
                f"recall@100 {rec:.4f} QPS {qps:.1f} p50 {p50:.2f} ms "
                f"(256-query requests); mixed 1/8/32: QPS {mqps:.1f} p50 "
                f"{mp50:.2f} ms | {card}")
        log(f"[graph] {f}: build {build_s:.2f} s ({len(idx.layers)} layers), "
            f"memory {mem[f]} bytes = {mem[f] / (n * d * 4):.4f} of fp32 "
            f"flat | {card}")
        built[f] = idx
    run = kernels.launch_counts()
    log(f"[graph] kernel launches on this run of the graph path: {run}")
    need(run["quantize"] > 0, "kernel quantize was never launched on the "
         "graph path")
    q8, q32 = GRAPH_ARMS
    log(f"[graph] memory ratio {q8} / {q32}: {mem[q8] / mem[q32]:.4f}")
    for f, idx in built.items():
        for ef in GRAPH_EF:
            s = idx.searcher(k, SearchParams(ef_search=ef))
            steps, b1, per_step = walk_request(s, queries[:256],
                                               profiled=ef == GRAPH_EF[0])
            kern = ("" if per_step is None
                    else f", {per_step:.1f} CUDA kernels a step")
            log(f"[graph] {f} ef_search {ef}, one 256-query request: "
                f"{steps['beam']} layer-0 steps ({steps['beam_iters'] / 256:.1f} "
                f"iterations a query), {steps['greedy']} upper-layer "
                f"steps{kern}, {b1} B1 launches")
            need(b1 == (1 if idx.quantized else 0),
                 f"{f}: {b1} B1 launches in one request")
    graph_recall(built)
    del built, corpus, queries, gt
    torch.cuda.empty_cache()
    return {"quantize": run["quantize"]}


# --------------------------------------------------------------------------
# phase 8: the NGT-style graph index (Table 3) and the ivf kind
# --------------------------------------------------------------------------

#: phase 8(a): integer arms (factory, metric) built on the card and on the
#: CPU from the same draws, held bit-equal
INDEX_EXACT = (("graph8,lpq8@gaussian:3", "ip"), ("graph8,lpq8", "l2"),
               ("graph8,lpq8@global_absmax", "angular"), ("graph8,lpq4", "ip"),
               ("ivf32,lpq8@gaussian:3", "ip"), ("ivf32,lpq8", "l2"),
               ("ivf32,lpq4", "ip"))
#: phase 8(a)'s fp32 arms: the card's recall@10 within 0.01 of the CPU's
INDEX_FP32 = (("graph8", "ip"), ("ivf32", "ip"))
#: phase 8(b): benchmarks/table3_graph_recall.py's arm pairs and two IVF
#: arms: (dataset, factory, knob, values)
TABLE3_ARMS = (
    ("sift", "graph24", "ef_search", (300,)),
    ("sift", "graph24,lpq8@global_minmax", "ef_search", (300,)),
    ("glove", "graph24", "ef_search", (300,)),
    ("glove", "graph24,lpq8@global_absmax", "ef_search", (300,)),
    ("product", "graph24", "ef_search", (300,)),
    ("product", "graph24,lpq8@gaussian:3", "ef_search", (300,)),
    ("sift", "ivf128,lpq8@global_minmax", "nprobe", (8, 32)),
    ("sift", "ivf128", "nprobe", (8, 32)),
)
#: the reference's recall@100 of TABLE3_ARMS at n=20000, 128 queries:
#: (mean, spread = max - min) over three seeds of data and k-means inits,
#: measured on the CPU by scripts/graph_reference_recall.py
REF_GRAPH = {
    ("sift", "graph24", 300): (0.7366, 0.0109),
    ("sift", "graph24,lpq8@global_minmax", 300): (0.7381, 0.0109),
    ("glove", "graph24", 300): (0.6263, 0.0129),
    ("glove", "graph24,lpq8@global_absmax", 300): (0.6227, 0.0146),
    ("product", "graph24", 300): (0.4018, 0.0037),
    ("product", "graph24,lpq8@gaussian:3", 300): (0.3854, 0.0100),
    ("sift", "ivf128,lpq8@global_minmax", 8): (0.2983, 0.0110),
    ("sift", "ivf128,lpq8@global_minmax", 32): (0.6206, 0.0196),
    ("sift", "ivf128", 8): (0.2983, 0.0110),
    ("sift", "ivf128", 32): (0.6206, 0.0196),
}
#: phase 8(c): the SIFT-like 1,000,000 x 128 arms, the graph's ef_search
#: and the IVF nprobe values, and the product-like int8 graph at width 257
INDEX_GRAPH_ARMS = ("graph24,lpq8@global_minmax", "graph24")
INDEX_IVF_ARMS = ("ivf1024,lpq8@global_minmax", "ivf1024")
INDEX_EF = 300
INDEX_NPROBE = (16, 64)
INDEX_N = 1_000_000
PRODUCT_GRAPH = "graph24,lpq8@gaussian:3"
#: the product-like graph's rows.  Its build is an exact self-join (O(N^2))
#: on B2 int8's byte-copy path at width 257: at 10^6 rows it took 109 of the
#: script's seconds, so this earlier path runs at a smaller depth (width,
#: build parts, request and the self-join check unchanged) to make room
#: for phase 11 inside the 1200 s limit
PRODUCT_GRAPH_N = 250_000
#: self-join rows of the product-like graph held against the plain version
JOIN_CHECK_ROWS = 1024


def graph_memory(idx, n: int, d: int) -> int:
    """The reference's graph memory formula (src/repro/knn/graph_index.py
    :330-339): the store over the index's own width (d+1 for ip) plus 4
    bytes a slot of the adjacency, a seed coordinate and a seed id."""
    w = d + 1 if idx.aug else d
    store = n * w + 3 * w * 4 if idx.quantized else n * w * 4
    s = idx.seeds.shape[0]
    return store + 4 * n * idx.degree + 4 * s * w + 4 * s


def ivf_memory(idx, n: int, d: int) -> int:
    """The reference's IVF memory formula (src/repro/knn/ivf.py:463-470):
    the store plus 4 bytes a centroid coordinate and a list slot."""
    store = n * d + 3 * d * 4 if idx.quantized else n * d * 4
    return store + 4 * idx.nlist * d + 4 * idx.nlist * idx.max_list


def index_draws(f: str, metric: str, corpus):
    """8(a)'s build inputs, made once on the CPU: the spec, and ``_given``
    (k-means centroids of the index's space, the ip augmentation column,
    the Eq. 1 constants), which each device would otherwise draw or reduce
    its own way."""
    import dataclasses

    import torch

    from repro_torch.knn import as_spec
    from repro_torch.knn.graph_index import mip_column
    from repro_torch.knn.ivf import kmeans

    spec = as_spec(f, metric=metric)
    x = torch.from_numpy(corpus)
    if spec.kind == "ivf":
        if spec.quant is not None:
            spec = dataclasses.replace(
                spec, quant=spec.quant.with_params(spec.quant.learn(x)))
        return spec, {"centroids": kmeans(x, int(spec.params["nlist"]), 0)}
    given = {}
    if metric == "ip":
        given["extra"] = mip_column(x)
        x = torch.cat([x, given["extra"][:, None]], dim=-1)
    given["centroids"] = kmeans(x, 32, 0)
    if spec.quant is not None:
        given["params"] = spec.quant.learn(x)
    return spec, given


def seed_tie(card, cpu) -> str:
    """Where the card's and the CPU's seed ids differ: each such seed's two
    rows and their float64 distances to the centroid (an exact tie, as a
    k-means cluster of two rows gives, is decided by f32 rounding)."""
    import torch

    a, b = card.seed_ids.cpu(), cpu.seed_ids
    x = cpu.store.data.to(torch.float64) if not cpu.quantized else None
    out = []
    for s in torch.nonzero(a != b).flatten().tolist():
        c = cpu.seeds[s].to(torch.float64)
        if x is None:
            out.append(f"seed {s}: card row {int(a[s])}, CPU row {int(b[s])}")
            continue
        da, db = (float(((x[int(i)] - c) ** 2).sum()) for i in (a[s], b[s]))
        out.append(f"seed {s}: card row {int(a[s])} ({da:.9g}), CPU row "
                   f"{int(b[s])} ({db:.9g})")
    return "; ".join(out)


def index_exact() -> None:
    """8(a): each integer graph / ivf arm built on the card and on the CPU
    from the same inputs (index_draws) has the same codes, the same
    adjacency, seeds and seed ids (graph) or lists and centroids (ivf), and
    a Searcher with buckets (1, 8, 32, 256) returns the same ids and scores
    on both for 256 queries (requests of 1, 8, 32 and 215), graph at
    ef_search 40 and 80, ivf at nprobe 4 and 16.  The fp32 arms: the
    card's recall@10 within 0.01 of the CPU's."""
    import numpy as np
    import torch

    from repro_torch.core.preserve import recall_at_k
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.knn.registry import get_impl

    n, d = 4000, 64
    rng = np.random.default_rng(8)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((256, d)).astype(np.float32)

    def knobs(kind):
        return ([SearchParams(ef_search=e) for e in (40, 80)] if kind == "graph"
                else [SearchParams(nprobe=p) for p in (4, 16)])

    def requests(idx, sp, k=10):
        s = idx.searcher(k, sp, batch_sizes=BUCKETS)
        out, start = [], 0
        for b in (1, 8, 32, 215):
            out.append(s(queries[start:start + b]))
            start += b
        return (torch.cat([r.scores.cpu() for r in out]),
                torch.cat([r.ids.cpu() for r in out]))

    for f, metric in INDEX_EXACT:
        spec, given = index_draws(f, metric, corpus)
        impl = get_impl(spec.kind)
        t0 = time.perf_counter()
        card = impl.build(corpus, spec, device="cuda", _given=given)
        card_s = time.perf_counter() - t0
        cpu = impl.build(corpus, spec, device="cpu", _given=given)
        need(torch.equal(card.store.data.cpu(), cpu.store.data),
             f"{f} {metric}: the card's codes differ from the CPU's")
        if spec.kind == "graph":
            need(torch.equal(card.adj.cpu(), cpu.adj),
                 f"{f} {metric}: the card's adjacency differs from the CPU's")
            need(torch.equal(card.seeds.cpu(), cpu.seeds),
                 f"{f} {metric}: seeds differ")
            need(torch.equal(card.seed_ids.cpu(), cpu.seed_ids),
                 f"{f} {metric}: seed ids differ (G-T5): {seed_tie(card, cpu)}")
            what = "adjacency, seeds and seed ids"
        else:
            need(torch.equal(card.lists.cpu(), cpu.lists),
                 f"{f} {metric}: the card's lists differ from the CPU's")
            need(torch.equal(card.centroids.cpu(), cpu.centroids),
                 f"{f} {metric}: centroids differ")
            what = f"lists (max_list {card.max_list}) and centroids"
        for sp in knobs(spec.kind):
            (sa, ia), (sb, ib) = requests(card, sp), requests(cpu, sp)
            need(torch.equal(ia, ib) and torch.equal(sa, sb),
                 f"{f} {metric} {sp}: the card's results differ from the "
                 "CPU's")
        knob = "ef_search 40 and 80" if spec.kind == "graph" else "nprobe 4 and 16"
        log(f"[index] {f} {metric} {n}x{d}: codes, {what} equal to the CPU "
            f"build's; Searcher ids and scores equal at {knob} (card build "
            f"{card_s:.2f} s)")
    gt = make_index("flat", corpus, device="cpu").search(queries, 10).ids
    for f, metric in INDEX_FP32:
        spec, given = index_draws(f, metric, corpus)
        impl = get_impl(spec.kind)
        sp = knobs(spec.kind)[0]
        rec = {dev: recall_at_k(gt, requests(impl.build(
            corpus, spec, device=dev, _given=given), sp)[1])
            for dev in ("cuda", "cpu")}
        ok = abs(rec["cuda"] - rec["cpu"]) <= 0.01
        log(f"[index] {f} {metric} (fp32) {n}x{d}: recall@10 card "
            f"{rec['cuda']:.4f} CPU {rec['cpu']:.4f} (|diff| <= 0.01: {ok})")
        need(ok, f"{f}: card recall {rec['cuda']:.4f} vs CPU {rec['cpu']:.4f}")


def index_recall() -> None:
    """8(b): Table 3's arm pairs and the IVF arms at n=20000, 128 queries:
    recall@100 against the fp32 flat arm within max(0.02, the reference's
    spread) of the reference's mean (REF_GRAPH)."""
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.knn import make_index

    data = {}
    for name, f, knob, values in TABLE3_ARMS:
        if name not in data:
            corpus, queries, metric = synthetic.load(name, 20000, 128)
            gt = make_index("flat", corpus, metric=metric).search(
                queries, 100).ids
            data[name] = corpus, queries, metric, gt
        corpus, queries, metric, gt = data[name]
        idx = make_index(f, corpus, metric=metric)
        for v in values:
            rec = recall_at_k(gt, idx.search(queries, 100, **{knob: v}).ids)
            want, spread = REF_GRAPH[name, f, v]
            tol = max(0.02, spread)
            ok = abs(rec - want) <= tol
            log(f"[table3] {name} 20000x{corpus.shape[1]} {metric} {f} {knob} "
                f"{v}: recall@100 {rec:.4f} (reference mean {want}, spread "
                f"{spread}, |diff| <= {tol}: {ok}) | {smi()}")
            need(ok, f"recall for {name} {f} {knob} {v}: {rec:.4f} vs {want} "
                 f"+- {tol}")


def index_path(err: dict) -> dict:
    """8(c): SIFT-like INDEX_N x 128 graph and IVF arms and the product-like
    int8 graph at width 257 through make_index + Searcher, one run of the
    path with the launch counters set to 0 before it and read after: build
    seconds and their parts, memory against the reference's formula,
    recall@100 against the fp32 flat arm, QPS and p50 at 256-query
    requests and for the mixed 1/8/32 stream.  Then each graph arm's walk
    (layer-0 steps, kernels a step under torch.profiler), each IVF arm's
    bytes a fine-scoring block gathers, and 1,024 rows of the product-like
    self-join held against the plain version.  The product-like graph runs
    at PRODUCT_GRAPH_N rows (its self-join is quadratic in N)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import quant as Qz
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.knn import ivf as IVF

    card = smi()
    n, k = INDEX_N, 100
    corpus, queries, metric = synthetic.load("sift", n, 1000)
    d = corpus.shape[1]
    gt = make_index("flat", corpus, metric=metric).search(queries, k).ids
    kernels.reset_launch_counts()
    built = {}

    def report(f, idx, sp, label):
        s = idx.searcher(k, sp)
        ids, qps, p50, _ = serve(idx, queries, k, (256,), s)
        need(ids.shape == (1000, k) and bool(torch.all(ids >= 0)),
             f"{f}: bad ids")
        rec = recall_at_k(gt, ids)
        _, mqps, mp50, _ = serve(idx, queries[:205], k, (1, 8, 32), s)
        log(f"[index] sift {n}x{d} {metric} {f} {label}: recall@100 "
            f"{rec:.4f} QPS {qps:.1f} p50 {p50:.2f} ms (256-query "
            f"requests); mixed 1/8/32: QPS {mqps:.1f} p50 {mp50:.2f} ms | "
            f"{card}")

    for f in INDEX_GRAPH_ARMS:
        t0 = time.perf_counter()
        idx = make_index(f, corpus, metric=metric)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mem = idx.memory_bytes()
        need(mem == graph_memory(idx, n, d), f"{f}: memory {mem} is not the "
             f"reference's formula's {graph_memory(idx, n, d)}")
        parts = ", ".join(f"{a} {b:.2f} s" for a, b in idx.build_parts.items())
        log(f"[index] {f}: build {build_s:.2f} s ({parts}), memory {mem} "
            f"bytes = {mem / (n * d * 4):.4f} of fp32 flat | {card}")
        report(f, idx, SearchParams(ef_search=INDEX_EF),
               f"ef_search {INDEX_EF}")
        built[f] = idx
    for f in INDEX_IVF_ARMS:
        t0 = time.perf_counter()
        idx = make_index(f, corpus, metric=metric)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mem = idx.memory_bytes()
        need(mem == ivf_memory(idx, n, d), f"{f}: memory {mem} is not the "
             f"reference's formula's {ivf_memory(idx, n, d)}")
        parts = ", ".join(f"{a} {b:.2f} s" for a, b in idx.build_parts.items())
        sizes = idx.list_sizes()
        log(f"[index] {f}: build {build_s:.2f} s ({parts}), max_list "
            f"{idx.max_list} (lists of {min(sizes)}-{max(sizes)} rows), "
            f"memory {mem} bytes = {mem / (n * d * 4):.4f} of fp32 flat | "
            f"{card}")
        for p in INDEX_NPROBE:
            report(f, idx, SearchParams(nprobe=p), f"nprobe {p}")
        built[f] = idx
    pn = PRODUCT_GRAPH_N
    pc, pq, pm = synthetic.load("product", pn, 256)
    t0 = time.perf_counter()
    prod = make_index(PRODUCT_GRAPH, pc, metric=pm)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = prod.searcher(k, SearchParams(ef_search=INDEX_EF))(pq)
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t0) * 1e3
    need(res.ids.shape == (256, k) and bool(torch.all(res.ids >= 0)),
         f"{PRODUCT_GRAPH}: bad ids")
    parts = ", ".join(f"{a} {b:.2f} s" for a, b in prod.build_parts.items())
    log(f"[index] product {pn}x{pc.shape[1]} {pm} {PRODUCT_GRAPH} (walk width "
        f"{prod.store.d}): build {build_s:.2f} s ({parts}), memory "
        f"{prod.memory_bytes()} bytes; one 256-query request at ef_search "
        f"{INDEX_EF}: {req_ms:.2f} ms (first, unwarmed) | {card}")
    run = kernels.launch_counts()
    log(f"[index] kernel launches on this run of the graph / ivf path: {run}")
    for name in ("quantize", "fused_topk_int8", "fused_topk_fp32"):
        need(run[name] > 0, f"kernel {name} was never launched on the graph "
             "/ ivf path")

    for f in INDEX_GRAPH_ARMS:
        s = built[f].searcher(k, SearchParams(ef_search=INDEX_EF))
        steps, b1, per_step = walk_request(s, queries[:256], profiled=True)
        log(f"[index] {f} ef_search {INDEX_EF}, one 256-query request: "
            f"{steps['beam']} steps ({steps['beam_iters'] / 256:.1f} "
            f"iterations a query), {per_step:.1f} CUDA kernels a step, {b1} "
            "B1 launches")
        need(b1 == (1 if built[f].quantized else 0),
             f"{f}: {b1} B1 launches in one request")
    for f in INDEX_IVF_ARMS:
        idx = built[f]
        for p in INDEX_NPROBE:
            width = min(p, idx.nlist) * idx.max_list
            rows = IVF.fine_block_rows(idx.store, width)
            gathered = rows * width * idx.store.d_eff * (
                1 if idx.quantized else 4)
            log(f"[index] {f} nprobe {p}: {width} candidates a query, "
                f"{rows} queries a fine-scoring block, {gathered} bytes of "
                f"rows gathered a block ({rows * width * idx.store.d_eff * 8}"
                f" more for the float64 copy of an integer dot)")

    # 1,024 rows of the width-257 self-join: kernel against plain version
    store = prod.store
    codes = store.data[:JOIN_CHECK_ROWS]
    q = store.encode_queries(Qz.dequantize(codes[:, : store.d], store.params))
    half = max(prod.degree // 2, 1)
    got = K.fused_topk(q, store.data, half + 1, "l2")
    want = F.fused_topk_plain(q, store.data, k=half + 1, metric="l2")
    hold("fused_topk_int8", got, want, q, store.data, half + 1, "l2", None,
         f"product self-join {JOIN_CHECK_ROWS} rows d={store.d}", err)
    log(f"[index] {PRODUCT_GRAPH}: {JOIN_CHECK_ROWS} self-join rows (Q="
        f"{JOIN_CHECK_ROWS}, N={pn}, d={store.d}, k={half + 1}, l2) equal to "
        "the plain version, ids and scores")
    del built, prod, corpus, queries, gt, pc, pq
    torch.cuda.empty_cache()
    return {name: run[name] for name in
            ("quantize", "fused_topk_int8", "fused_topk_fp32")}


# --------------------------------------------------------------------------
# phase 9: filtered search through every kind, and the stream kind
# --------------------------------------------------------------------------

#: filter selectivities, and the seed every filter bitmap is drawn from
FILTER_SELS = (0.02, 0.25, 0.9)
FILTER_SEED = 0
#: phase 9(a): every ported kind, filtered, against its own exhaustive
#: ranking cut to the allowed rows (factory -> build overrides)
FILTER_EXACT = {
    "flat": {}, "flat,lpq8@global_minmax": {}, "flat,lpq4+r32": {},
    "pq16+lpq": {"kmeans_iters": 4}, "pq16x4,lpq8": {"kmeans_iters": 4},
    "ivf32,lpq8@global_minmax": {"kmeans_iters": 4},
    "hnsw8,lpq8@global_minmax": {"ef_construction": 40, "batch_size": 128},
    "graph8,lpq8@global_minmax": {},
    "stream(flat,lpq4@global_minmax)+r32": {"seal_threshold": 512},
}
#: 9(a): integer arms filtered on the card and on the CPU, built from the
#: same draws as 7(a) and 8(a)
FILTER_CARD_CPU = ("flat,lpq8@global_minmax", "ivf32,lpq8@global_minmax",
                   "hnsw8,lpq8@global_minmax", "graph8,lpq8@global_minmax")
#: 9(a): one write sequence on the card and on the CPU
STREAM_EXACT = ("stream(flat,lpq8@global_minmax)",
                "stream(flat,lpq4@global_absmax)+r32")
#: 9(b): the product-like arms (4,000,000 x 256, ip) and the SIFT-like ones
#: (1,000,000 x 128, l2): (factory, knob, value, selectivities)
FILTER_PRODUCT = ("flat", "flat,lpq8@gaussian:3", "flat,lpq4", "pq32+lpq",
                  "pq64x4+lpq")
FILTER_SIFT = (("ivf1024,lpq8@global_minmax", "nprobe", 64, FILTER_SELS),
               ("graph24,lpq8@global_minmax", "ef_search", 300, (0.25, 0.9)))
#: 9(c): the stream arms on product-like rows, and the churn
STREAM_ARMS = {"stream(flat,lpq8@gaussian:3)": "flat,lpq8@gaussian:3",
               "stream(flat,lpq4)+r32": "flat,lpq4+r32"}
#: rounds of churn: 5, not the 16 first planned.  The plan fetches depth +
#: masked rows from each segment, so a request's B2 scan over the bulk
#: segment grows with its tombstones (0.15 s at 2,048, 0.7 s at 8,000,
#: 1.1-3.6 s at 10,000-16,000, 8.6-10 s at 31,000 on the H100, PERF.md).
#: With phases 7(c) and 8(c) at full size the script ran 926 s of its
#: 1200 s limit at 8 rounds with 8(c) at a quarter of its rows, so the
#: rounds are the first cut.  An odd count leaves the last snapshot a
#: memtable (a round upserts half the seal threshold), whose fp32 scan the
#: checks then hold against its plain version too
STREAM_ROUNDS = 5
STREAM_UPSERT = 2048          # a round's upserts: half replace live ids
STREAM_DELETE = 1024
#: 9(c)'s filtered request after churn: its selectivity and queries.  The
#: stream plan fetches depth + masked rows from each segment (as the
#: reference's ``mutable.py`` does), so at 0.25 the 4,000,000-row segment
#: would be asked for k = 3,000,000 of B2 int8, over a minute for one
#: query (scripts/large_k_probe.py: 4.35 s at k = 300,000, 18.6 s at
#: k = 10^6); at 0.99 it is asked for about 75,000
FILTER_AFTER_CHURN = 0.99
FILTER_AFTER_CHURN_Q = 32
#: the churned snapshot's least recall@100 against an exact fp32 scan of
#: ``live_items()``: with more than one source the merge re-scores every
#: candidate in fp32, and each segment over-fetches by its tombstones
STREAM_RECALL = 0.99


def allow_mask(n: int, sel: float, salt: int = 0):
    """A random filter bitmap over n external ids at selectivity ``sel``,
    made from FILTER_SEED (at least one row allowed)."""
    import numpy as np

    rng = np.random.default_rng([FILTER_SEED, int(sel * 1000), salt])
    m = rng.random(n) < sel
    m[int(rng.integers(n))] = True
    return m


def filter_exact() -> None:
    """9(a): (1) every ported kind at 4,000 x 64, filtered at each
    selectivity, against its own exhaustive ranking (ef_search = N, nprobe
    = nlist, rerank depth N) cut to the allowed rows: scores bit-equal, ids
    equal up to order inside tie groups; (2) the integer flat, ivf, hnsw
    and graph arms built on the card and on the CPU from one set of draws:
    a bucketed filtered Searcher's ids and scores equal; (3) one write
    sequence on two stream arms, on the card and on the CPU: segments,
    external ids, live bitmaps, counters and epoch equal, and a filtered
    Searcher equal at every bucket (bit for bit where one integer source
    passes through; where the merge re-scores in fp32 on each device,
    within rtol 1e-5 of the row scale, ids equal outside near-ties)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams, as_spec, make_index
    from repro_torch.knn.hnsw import HNSWIndex, draw_levels
    from repro_torch.knn.registry import get_impl
    from repro_torch.testing import (build_with_writes, lifecycles_equal,
                                     post_filter, stream_lifecycle,
                                     tie_groups_equal)

    n, d, k = 4000, 64, 10
    rng = np.random.default_rng(9)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((256, d)).astype(np.float32)
    q32 = queries[:32]

    def depth_searcher(idx, kk, sp):
        kw = {}
        if getattr(idx, "handles_rerank", False) or \
                getattr(idx, "rerank_store", None) is not None:
            kw["rerank"] = n
        return idx.searcher(kk, sp, batch_sizes=None, strict=False, **kw)

    for f, over in FILTER_EXACT.items():
        t0 = time.perf_counter()
        if f.startswith("stream"):
            idx = build_with_writes(
                make_index, f, corpus, bulk=n // 2, chunk=over["seal_threshold"],
                dead=np.arange(5, n // 2, 97), metric="ip", **over)
        else:
            idx = make_index(f, corpus, metric="ip", **over)
        nlist = getattr(idx, "nlist", 8)
        full = depth_searcher(idx, n, SearchParams(nprobe=nlist, ef_search=n))(
            q32)
        fs, fi = full.scores.cpu().numpy(), full.ids.cpu().numpy()
        for sel in FILTER_SELS:
            allow = allow_mask(n, sel)
            os_, oi = post_filter(fs, fi, allow, k)
            res = depth_searcher(idx, k, SearchParams(
                nprobe=nlist, ef_search=n,
                filter=Filter.from_mask(allow)))(q32)
            gs, gi = res.scores.cpu().numpy(), res.ids.cpu().numpy()
            need(bool(allow[gi[gi >= 0]].all()),
                 f"{f} at {sel}: a disallowed id came back")
            need(np.array_equal(gs, os_) and tie_groups_equal(gs, gi, oi),
                 f"{f} at {sel}: filtered search differs from its own "
                 "exhaustive ranking cut to the allowed rows")
        log(f"[filter] {f} ip {n}x{d}: filtered at {FILTER_SELS} equal to its "
            f"own exhaustive ranking cut to the allowed rows (scores "
            f"bit-equal, ids up to tie order; {time.perf_counter() - t0:.2f} s)")
        del idx

    levels = draw_levels(n, 8, 0)
    for f in FILTER_CARD_CPU:
        spec = as_spec(f, metric="ip")
        if spec.kind in ("graph", "ivf"):
            spec, given = index_draws(f, "ip", corpus)
            built = [get_impl(spec.kind).build(corpus, spec, device=dev,
                                               _given=given)
                     for dev in ("cuda", "cpu")]
        else:
            qp = spec.quant.learn(torch.from_numpy(corpus))
            spec = dataclasses.replace(spec, quant=spec.quant.with_params(qp))
            if spec.kind == "hnsw":
                built = [HNSWIndex.build(corpus, spec, device=dev,
                                         ef_construction=40, batch_size=128,
                                         _levels=levels)
                         for dev in ("cuda", "cpu")]
            else:
                built = [make_index(spec, corpus, device=dev)
                         for dev in ("cuda", "cpu")]
        for sel in FILTER_SELS:
            sp = SearchParams(nprobe=4, ef_search=40,
                              filter=Filter.from_mask(allow_mask(n, sel)))
            outs = []
            for idx in built:
                s, start, parts = idx.searcher(k, sp, batch_sizes=BUCKETS), 0, []
                for b in (1, 8, 32, 215):
                    parts.append(s(queries[start:start + b]))
                    start += b
                outs.append((torch.cat([r.scores.cpu() for r in parts]),
                             torch.cat([r.ids.cpu() for r in parts])))
            (sa, ia), (sb, ib) = outs
            need(torch.equal(ia, ib) and torch.equal(sa, sb),
                 f"{f} at {sel}: the card's filtered results differ from the "
                 "CPU's")
        log(f"[filter] {f} ip {n}x{d}: built on the card and the CPU from one "
            f"set of draws; filtered Searcher ids and scores equal at "
            f"{FILTER_SELS}, requests of 1, 8, 32 and 215")

    for f in STREAM_EXACT:
        allow = allow_mask(6000, 0.25, 1)
        runs = [stream_lifecycle(make_index, f, corpus, queries, allow,
                                 (1, 8, 32, 215), bulk=2000, k=k,
                                 searcher_kw={"batch_sizes": BUCKETS},
                                 metric="ip", device=dev, seal_threshold=512,
                                 max_segments=4)
                for dev in ("cuda", "cpu")]
        diff, exact, same = lifecycles_equal(*runs, allow, 1e-5)
        need(diff is None, f"{f}: the card's write sequence differs from the "
             f"CPU's: {diff}")
        c = runs[0][-1][1]
        log(f"[stream] {f} ip: one write sequence (seal_threshold 512, "
            f"{c['seals']} seals, {c['compactions']} compactions, "
            f"{c['recalibrations']} recalibrations) on the card and the CPU: "
            f"segments, external ids, live bitmaps, counters and epoch equal "
            f"at 8 checkpoints; filtered Searcher bit-equal at the {exact} "
            f"single-source checkpoints, fp32 merges within rtol 1e-5 "
            f"({same} scores bit-equal)")


def check_masked(f, idx, queries, depth, mask, err, tag,
                 buckets=BUCKETS) -> None:
    """A filtered arm's scan kernel against its plain version given the
    same mask, at each of ``buckets`` (after the run's counts were read):
    B2 int8 / B3 / B4 / B5 bit-equal, B2 fp32 within rtol 1e-5."""
    import torch

    from repro_torch.engine import PQStore
    from repro_torch.engine.scorer import _prepare_pq_lut
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K

    store = idx.store
    if isinstance(store, PQStore):
        for b in buckets:
            lut = _prepare_pq_lut(queries[:b], store, idx.metric)
            got = K.fused_adc_topk(lut, store.codes, depth,
                                   packed=store.packed, mask=mask)
            want = adc_plain(lut, store.codes, depth, store.packed, mask)
            hold_adc(got, want, f"{f} {tag} Q={b} k={depth}")
        return
    name = KERNEL_OF["int4" if store.packed else
                     "int8" if store.quantized else "fp32"]
    for b in buckets:
        q = store.encode_queries(queries[:b])
        got = K.fused_topk(q, store.data, depth, idx.metric,
                           packed=store.packed, mask=mask)
        if store.packed:
            qe, qo = K.split_nibble_queries(q)
            want = F.fused_topk4_plain(qe, qo, store.data, k=depth,
                                       metric=idx.metric, mask=mask)
        else:
            want = F.fused_topk_plain(q, store.data, k=depth,
                                      metric=idx.metric, mask=mask)
        hold(name, got, want, q, store.data, depth, idx.metric, mask,
             f"{f} {tag} Q={b} k={depth}", err)


def stream_sources(idx, depth, allow=None) -> list:
    """(label, index, k) of each source a stream index's plan scans, at the
    plan's over-fetch (``MutableIndex.plan``): every segment's inner index
    at ``depth`` + its masked rows (tombstones, and rows ``allow`` leaves
    out), and the memtable's flat fp32 scan likewise."""
    from repro_torch import engine
    from repro_torch.knn.flat import FlatIndex

    out = []
    for j, seg in enumerate(idx.manifest.segments):
        ok = seg.live if allow is None else seg.live & allow[seg.ext_ids]
        out.append((f"segment {j}", seg.index,
                    min(seg.n, depth + seg.n - int(ok.sum()))))
    mvecs, mids = idx.memtable.snapshot()
    m = int(mvecs.shape[0])
    if m:
        ok = m if allow is None else int(allow[mids].sum())
        mem = FlatIndex(metric=idx.metric, store=engine.CodeStore.dense(
            mvecs, device=idx.device))
        out.append(("memtable", mem, min(m, depth + m - ok)))
    return out


def filtered_arm(f, idx, queries, k, params, sels, card, tag, n):
    """One arm's unfiltered and filtered requests: p50 and QPS at 256-query
    requests and in the mixed 1/8/32 stream, and their ratio; returns
    {sel: (allow mask, ids)}."""
    import dataclasses

    from repro_torch.filter import Filter

    _ids, qps0, p500, s0 = serve(idx, queries, k, (256,),
                                 idx.searcher(k, params))
    _, mqps0, mp500, _ = serve(idx, queries[:205], k, (1, 8, 32), s0)
    log(f"[filter] {tag} {f}: unfiltered QPS {qps0:.1f} p50 {p500:.2f} ms "
        f"(256-query requests); mixed 1/8/32: QPS {mqps0:.1f} p50 "
        f"{mp500:.2f} ms | {card}")
    out = {}
    for sel in sels:
        allow = allow_mask(n, sel)
        sp = dataclasses.replace(params, filter=Filter.from_mask(allow))
        s = idx.searcher(k, sp)
        ids, qps, p50, _ = serve(idx, queries, k, (256,), s)
        _, mqps, mp50, _ = serve(idx, queries[:205], k, (1, 8, 32), s)
        got = ids.cpu().numpy()
        need(bool(allow[got[got >= 0]].all()),
             f"{tag} {f} at {sel}: a disallowed id came back")
        st = s(queries[:1]).stats
        extra = (f", {st['filter_lists_skipped']} lists skipped"
                 if "filter_lists_skipped" in st else "")
        log(f"[filter] {tag} {f} at {sel} ({int(allow.sum())} rows allowed"
            f"{extra}): QPS {qps:.1f} p50 {p50:.2f} ms (256-query requests; "
            f"p50 {p50 / p500:.3f}x, QPS {qps / qps0:.3f}x the unfiltered); "
            f"mixed 1/8/32: QPS {mqps:.1f} p50 {mp50:.2f} ms ({mp50 / mp500:.3f}"
            f"x, {mqps / mqps0:.3f}x) | {card}")
        out[sel] = (allow, got, s)
    return out


def filter_path(err: dict, corpus, queries, sift_n: int = 1_000_000) -> dict:
    """9(b): filtered search at full width, as runs of the main path
    (counters set to 0 before each corpus's drive, read after); each
    masked kernel launch is then held against its plain version given the
    same mask at every bucket.  Product-like 4,000,000 x 256 ip: the five
    arms at 256-query requests and in the mixed stream, each selectivity
    beside the unfiltered; flat's ids equal a flat scan over the allowed
    rows alone mapped back, outside near-ties.  SIFT-like 1,000,000 x 128
    l2: ivf1024 at nprobe 64 (lists skipped), graph24 at ef_search 300
    (walk steps a request)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.data import synthetic
    from repro_torch.filter import overfetch
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K
    from repro_torch.testing import fp32_near_equal

    card = smi()
    k = 100
    n = corpus.shape[0]
    counts = dict.fromkeys(kernels.launch_counts(), 0)
    kernels.reset_launch_counts()
    built = {}
    for f in FILTER_PRODUCT:
        t0 = time.perf_counter()
        idx = make_index(f, corpus, metric="ip")
        torch.cuda.synchronize()
        log(f"[filter] product {n}x{corpus.shape[1]} ip {f}: build "
            f"{time.perf_counter() - t0:.2f} s")
        built[f] = (idx, filtered_arm(f, idx, queries, k, SearchParams(),
                                      FILTER_SELS, card, "product", n))
    run = kernels.launch_counts()
    log(f"[filter] product: kernel launches on this run: {run}")
    for name, c in run.items():
        counts[name] += c
    # flat over the allowed rows alone, mapped back
    flat, sels = built["flat"]
    for sel, (allow, _ids, s) in sels.items():
        res = s(queries)
        keep = torch.from_numpy(np.flatnonzero(allow)).to(corpus.device)
        sub = make_index("flat", corpus[keep], metric="ip").search(queries, k)
        back = torch.where(sub.ids >= 0, keep[sub.ids.clamp_min(0).long()]
                           .to(torch.int32), -1)
        ok, eq = fp32_near_equal(
            res.scores.cpu().numpy(), res.ids.cpu().numpy(),
            sub.scores.cpu().numpy(), back.cpu().numpy(), 1e-5)
        need(ok, f"product flat at {sel}: filtered ids differ from a flat "
             "scan over the allowed rows alone")
        log(f"[filter] product flat at {sel}: ids equal a flat scan over the "
            f"{int(allow.sum())} allowed rows alone, mapped back, outside "
            f"near-ties; scores within rtol 1e-5 ({eq} of {res.ids.numel()} "
            "bit-equal)")
        del sub
    for f, (idx, sels) in built.items():
        for sel, (allow, _ids, _s) in sels.items():
            mask = torch.from_numpy(np.array(allow)).to(corpus.device)
            check_masked(f, idx, queries, k, mask, err, f"at {sel}")
        log(f"[filter] product {f}: the masked scan at N={n}, Q in {BUCKETS}, "
            f"k={k}, each selectivity, equal to the plain version given the "
            "same mask")
    del built, flat, sels
    torch.cuda.empty_cache()

    sc, sq, sm = synthetic.load("sift", sift_n, 1000)
    ns = sc.shape[0]
    kernels.reset_launch_counts()
    sift = {}
    for f, knob, value, sels in FILTER_SIFT:
        t0 = time.perf_counter()
        idx = make_index(f, sc, metric=sm)
        torch.cuda.synchronize()
        log(f"[filter] sift {ns}x{sc.shape[1]} {sm} {f}: build "
            f"{time.perf_counter() - t0:.2f} s")
        params = SearchParams(**{knob: value})
        out = filtered_arm(f, idx, sq, k, params, sels, card,
                           f"sift {knob} {value}", ns)
        if knob == "ef_search":
            for sel, (_a, _i, s) in out.items():
                steps, _b1, _ = walk_request(s, sq[:256], profiled=False)
                log(f"[filter] sift {f} at {sel}: ef {s.params.ef_search} -> "
                    f"{max(value, overfetch(k, sel, ns))}, one 256-query "
                    f"request {steps['beam']} steps "
                    f"({steps['beam_iters'] / 256:.1f} iterations a query)")
        sift[f] = (idx, out)
    run = kernels.launch_counts()
    log(f"[filter] sift: kernel launches on this run: {run}")
    for name, c in run.items():
        counts[name] += c
    # the masked coarse probe of the ivf arm against the plain version
    idx, out = sift["ivf1024,lpq8@global_minmax"]
    cents = idx.centroids
    for sel, (_a, _i, s) in out.items():
        _fm, lmask, _st = idx._filter_masks(s.params)
        for b in BUCKETS:
            q = sq[:b]
            got = K.fused_topk(q, cents, 64, sm, mask=lmask)
            want = F.fused_topk_plain(q, cents, k=64, metric=sm, mask=lmask)
            hold("fused_topk_fp32", got, want, q, cents, 64, sm, lmask,
                 f"ivf1024 probe at {sel} Q={b}", err)
    log(f"[filter] sift ivf1024,lpq8@global_minmax: the list-masked coarse "
        f"probe (B2 fp32, 1024 centroids, k=64) at each selectivity and "
        f"bucket within rtol 1e-5 of the plain version")
    del sift, idx, out, sc, sq
    torch.cuda.empty_cache()
    return counts


def stream_path(err: dict, corpus, queries) -> dict:
    """9(c): the stream kind at full width.  Each arm is two runs of the
    main path (counters set to 0 before, read after, and every check's own
    launches made outside them).  The first: a bulk build of the
    product-like rows into one sealed segment (seal_threshold 4,096,
    max_segments 8), then STREAM_ROUNDS rounds of 2,048 upserts (half
    replacing random live ids), 1,024 deletes of random live ids, a replan
    and one 256-query request, with the seconds of the writes, the seals,
    the compactions and the merge store's rebuilds; the churned snapshot
    (p50, QPS against the fresh build); one filtered request.  Its checks:
    no deleted or disallowed id, recall@100 at least STREAM_RECALL against
    an exact fp32 scan of ``live_items()``, and every source's scan at the
    over-fetch k the plan gave it (up to tens of thousands) equal to its
    plain version.  The second: ``compact(full=True)`` and a request at
    every bucket, held bit-equal to a from-scratch build of the inner
    factory on ``live_items()``."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams, make_index

    card = smi()
    k = 100
    n, d = corpus.shape
    host = corpus.cpu().numpy()
    pool = synthetic.product_embeddings(
        STREAM_ROUNDS * STREAM_UPSERT, d, n_queries=1, seed=5)[0].cpu().numpy()
    counts = dict.fromkeys(kernels.launch_counts(), 0)
    for arm, inner in STREAM_ARMS.items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        idx = make_index(arm, host, metric="ip")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _, fqps, fp50, _ = serve(idx, queries, k, (256,))
        log(f"[stream] product {n}x{d} ip {arm}: bulk build {build_s:.2f} s "
            f"into {idx.stats()['segments']} segment; fresh QPS {fqps:.1f} "
            f"p50 {fp50:.2f} ms (256-query requests) | {card}")
        # time the compactions and the merge store's rebuilds inside writes
        # and plans
        timed = {"compaction": 0.0, "merge_store": 0.0}

        def wrap(obj, name, key):
            fn = getattr(obj, name)

            def run(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timed[key] += time.perf_counter() - t
                return out
            setattr(obj, name, run)

        wrap(idx.compactor, "merge", "compaction")
        wrap(idx, "_build_merge_store", "merge_store")
        rng = np.random.default_rng([FILTER_SEED, 9])
        live = np.zeros(n + STREAM_ROUNDS * STREAM_UPSERT, bool)
        live[:n] = True
        next_id = n
        totals = dict.fromkeys(("write", "seal", "delete", "plan", "request"),
                               0.0)
        for r in range(STREAM_ROUNDS):
            half = STREAM_UPSERT // 2
            repl = rng.choice(np.flatnonzero(live), half, replace=False)
            new = np.arange(next_id, next_id + half)
            next_id += half
            before = dict(timed)
            seals = idx.counters["seals"]
            t = time.perf_counter()
            idx.upsert(np.concatenate([repl, new]),
                       pool[r * STREAM_UPSERT:(r + 1) * STREAM_UPSERT])
            torch.cuda.synchronize()
            up = time.perf_counter() - t
            live[new] = True
            comp = timed["compaction"] - before["compaction"]
            seal = up - comp if idx.counters["seals"] > seals else 0.0
            dels = rng.choice(np.flatnonzero(live), STREAM_DELETE,
                              replace=False)
            t = time.perf_counter()
            idx.delete(dels)
            dl = time.perf_counter() - t
            live[dels] = False
            t = time.perf_counter()
            s = idx.searcher(k)
            torch.cuda.synchronize()
            pl = time.perf_counter() - t
            t = time.perf_counter()
            res = s(queries[:256])
            torch.cuda.synchronize()
            rq = time.perf_counter() - t
            got = res.ids.cpu().numpy()
            need(bool(live[got[got >= 0]].all()),
                 f"{arm} round {r}: a deleted id came back")
            st = idx.stats()
            ms = timed["merge_store"] - before["merge_store"]
            for key, v in (("write", up - seal - comp), ("seal", seal),
                           ("delete", dl), ("plan", pl - ms),
                           ("request", rq)):
                totals[key] += v
            log(f"[stream] {arm} round {r + 1}: upsert {up:.3f} s (seal "
                f"{seal:.3f}, compaction {comp:.3f}), delete {dl:.3f} s, "
                f"replan {pl:.3f} s (merge store {ms:.3f}), request "
                f"{rq * 1e3:.1f} ms; {st['segments']} segments, "
                f"{st['tombstones']} tombstones, memtable "
                f"{st['memtable_rows']}, reranked {res.stats['reranked']}")
        # the churned snapshot: three 256-query requests (each over a second)
        got, cqps, cp50, cs = serve(idx, queries[:768], k, (256,))
        got = got.cpu().numpy()
        st = idx.stats()
        reranked = cs(queries[:1]).stats["reranked"]
        # one filtered request over the external ids
        horizon = next_id
        depth = cs.rerank.depth if cs.rerank is not None else k
        allow = allow_mask(horizon, FILTER_AFTER_CHURN, 2)
        t = time.perf_counter()
        fres = idx.searcher(k, SearchParams(filter=Filter.from_mask(allow)))(
            queries[:FILTER_AFTER_CHURN_Q])
        torch.cuda.synchronize()
        fq = time.perf_counter() - t
        run = kernels.launch_counts()
        # the checks below launch kernels of their own: none of them counts
        need(bool(np.isin(got[got >= 0], np.flatnonzero(live)).all()),
             f"{arm}: a deleted id came back after churn")
        ext, vecs = idx.live_items()
        exact = make_index("flat", vecs, metric="ip")
        gt = exact.search(queries[:768], k).ids.cpu().numpy()
        gt = np.where(gt >= 0, ext[np.clip(gt, 0, None)], -1)
        rec = recall_at_k(torch.from_numpy(gt), torch.from_numpy(got))
        del exact, vecs
        log(f"[stream] {arm} after {STREAM_ROUNDS} rounds: {st['segments']} "
            f"segments, {st['tombstones']} tombstones, {st['seals']} seals, "
            f"{st['compactions']} compactions ({st['recalibrations']} "
            f"recalibrated), reranked {reranked}; "
            f"QPS {cqps:.1f} p50 {cp50:.2f} ms (256-query requests; p50 "
            f"{cp50 / fp50:.3f}x the fresh build's); recall@100 {rec:.4f} "
            f"against an exact fp32 scan of live_items(); seconds over the "
            f"rounds: " + ", ".join(f"{a} {b:.2f}" for a, b in totals.items())
            + f", compaction {timed['compaction']:.2f}, merge store "
            f"{timed['merge_store']:.2f} | {card}")
        need(rec >= STREAM_RECALL,
             f"{arm}: recall@100 {rec:.4f} after churn, below {STREAM_RECALL}")
        # every source of the churned request and of the filtered one, at
        # its over-fetch k, against its plain version on the request's bucket
        sources = stream_sources(idx, depth)
        fsources = stream_sources(idx, depth, allow)
        # the plan re-scores every candidate its sources return
        for srcs, rescored in ((sources, reranked),
                               (fsources, fres.stats["reranked"])):
            width = sum(c for *_, c in srcs)
            need(width == rescored, f"{arm}: the sources' k sum to {width}, "
                 f"the request re-scored {rescored}")
        for label, src, kj in sources:
            check_masked(f"{arm} {label}", src, queries, kj, None, err,
                         "after churn", buckets=(256,))
        for label, src, kj in fsources:
            check_masked(f"{arm} {label}", src, queries, kj, None, err,
                         f"filtered at {FILTER_AFTER_CHURN}",
                         buckets=(FILTER_AFTER_CHURN_Q,))
        log(f"[stream] {arm}: each source's scan equal to its plain version "
            f"(int bit-equal, fp32 within rtol 1e-5) at the churned request's "
            f"k ({', '.join(f'{a} {c}' for a, _s, c in sources)}; Q=256) and "
            f"the filtered one's ({', '.join(f'{a} {c}' for a, _s, c in fsources)};"
            f" Q={FILTER_AFTER_CHURN_Q})")
        got = fres.ids.cpu().numpy()
        need(bool(live[got[got >= 0]].all() and allow[got[got >= 0]].all()),
             f"{arm}: a filtered request returned a dead or disallowed id")
        log(f"[stream] {arm}: one filtered request ({FILTER_AFTER_CHURN_Q} "
            f"queries) at {FILTER_AFTER_CHURN} over {horizon} external ids: "
            f"{fq * 1e3:.1f} ms, every id live and allowed; the bulk segment "
            f"was asked for k = {fsources[0][2]} (at 0.25 it would be "
            f"{stream_sources(idx, depth, allow_mask(horizon, 0.25, 2))[0][2]})")
        del sources, fsources
        # full compaction and its requests: a second run of the path
        kernels.reset_launch_counts()
        t = time.perf_counter()
        idx.compact(full=True)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t
        a_s = idx.searcher(k)
        after = [a_s(queries[:b]) for b in BUCKETS]
        for name, c in kernels.launch_counts().items():
            run[name] += c
        ext, vecs = idx.live_items()
        scratch = make_index(inner, vecs, metric="ip")
        b_s = scratch.searcher(k)
        for b, a in zip(BUCKETS, after):
            bb = b_s(queries[:b])
            mapped = torch.where(bb.ids >= 0, torch.from_numpy(ext).to(
                bb.ids.device)[bb.ids.clamp_min(0).long()].to(torch.int32), -1)
            need(torch.equal(a.ids, mapped) and torch.equal(a.scores, bb.scores),
                 f"{arm}: full compaction differs from a from-scratch {inner} "
                 f"build at Q={b}")
        cache = idx._merge_cache
        merge_bytes = (cache[1].data.numel() * cache[1].data.element_size()
                       if cache is not None else 0)
        log(f"[stream] {arm}: compact(full=True) {full_s:.2f} s -> "
            f"{idx.stats()['segments']} segment of {idx.n} rows, bit-equal to "
            f"a from-scratch {inner} build on live_items() at Q in {BUCKETS}; "
            f"memory {idx.memory_bytes()} bytes (host raw + device codes), "
            f"merge store {merge_bytes} bytes on the card | {card}")
        log(f"[stream] {arm}: kernel launches on this run: {run}")
        for name, c in run.items():
            counts[name] += c
        del idx, scratch, a_s, b_s, cs, s, res, fres, after, vecs
        torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 10: the scoring cascade and per-region Eq. 1 constants
# --------------------------------------------------------------------------

#: phase 10(a): the reference's conformance arms and overrides
#: (tests/test_conformance.py:44-53), built on the card and on the CPU
#: from one set of draws (repro_torch.testing.build_draws)
CASCADE_EXACT = {
    "cascade(flat,lpq4|r32)": {},
    "cascade(pq16x4|lpq8|r32)": {"kmeans_iters": 4},
    "ivf8,lpq8,regions": {"kmeans_iters": 4},
    "hnsw8,lpq8,regions": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq4,regions": {"n_seeds": 16},
}
CASCADE_STREAM = "stream(cascade(flat,lpq8|r32))"
#: phase 10(b)-(c): benchmarks/bench_cascade.py's cascades at its budgets
#: (ARMS_FULL, built with its kmeans_iters=4), and the single-stage arms
#: beside them (its gate: a cascade reaches the first one's recall@10 at no
#: more than the second one's bytes a query)
CASCADE_ARMS = {"cascade(pq16x4|lpq8|r32)": (768, 96),
                "cascade(flat,lpq4|r32)": (64,)}
CASCADE_BUILD = {"kmeans_iters": 4}
CASCADE_BESIDE = ("flat,lpq8@gaussian:3", "flat,lpq4")
#: phase 10(b): (dataset, factory, k, build overrides, knob, values) at
#: n=20000, 128 queries
REGION_RECALL = (
    ("product", "cascade(pq16x4|lpq8|r32)", 10, CASCADE_BUILD, "budgets",
     ((768, 96),)),
    ("product", "cascade(flat,lpq4|r32)", 10, CASCADE_BUILD, "budgets",
     ((64,),)),
    ("sift", "ivf128,lpq8@global_minmax,regions", 100, {}, "nprobe", (8, 32)),
    ("sift", "graph24,lpq8@global_minmax,regions", 100, {}, "ef_search",
     (300,)),
    ("product", "hnsw32,lpq8@gaussian:3,regions", 100, GRAPH_BUILD,
     "ef_search", (300,)),
)
#: the reference's recall of REGION_RECALL (recall@10 for the cascades,
#: recall@100 otherwise): (mean, spread = max - min) over three seeds of
#: data and draws, measured on the CPU by scripts/cascade_reference_recall.py
REF_CASCADE = {
    ("product", "cascade(pq16x4|lpq8|r32)", (768, 96)): (0.4208, 0.0117),
    ("product", "cascade(flat,lpq4|r32)", (64,)): (0.9888, 0.0023),
    ("sift", "ivf128,lpq8@global_minmax,regions", 8): (0.2983, 0.0110),
    ("sift", "ivf128,lpq8@global_minmax,regions", 32): (0.6206, 0.0196),
    ("sift", "graph24,lpq8@global_minmax,regions", 300): (0.7382, 0.0109),
    ("product", "hnsw32,lpq8@gaussian:3,regions", 300): (0.9020, 0.0045),
}
#: phase 10(c): the SIFT-like regions arms (beside 8(c)'s INDEX_*_ARMS)
REGION_IVF = "ivf1024,lpq8@global_minmax,regions"
REGION_GRAPH = "graph24,lpq8@global_minmax,regions"
#: phase 10's kernels: the lpq4 head (B3), the int8 arm beside it (B2
#: int8), the ivf probe and the graph's entry probe (B2 fp32) and every Eq.
#: 1 encode (B1)
CASCADE_KERNELS = ("quantize", "fused_topk_int8", "fused_topk_fp32",
                   "fused_topk4")


def _store_codes(idx) -> list:
    """Every store an index scans or gathers: a cascade's head and stages,
    a regions build's store and regional store."""
    if idx.kind == "cascade":
        stores = [idx.head.store, *idx.stage_stores]
    else:
        stores = [idx.store]
        if getattr(idx, "region_store", None) is not None:
            stores.append(idx.region_store)
    return [s.codes if hasattr(s, "codes") else s.data for s in stores]


def cascade_exact() -> None:
    """10(a): each arm of CASCADE_EXACT at the reference conformance's
    size (tests/test_conformance.py: 384 x 32, ip; 256 queries), built on
    the card
    and on the CPU from one set of draws: every store's codes and the
    region constants equal; a cascade's head scan at its fetch depth and
    each refinement stage on the same candidates bit-equal where integer
    (ids and scores), fp32 stages within rtol 1e-5 of the row scale; a
    regional walk's integer beam (HNSW, graph) bit-equal before its
    re-score; a bucketed Searcher unfiltered and filtered at FILTER_SELS
    within rtol 1e-5 (ids equal outside near-ties).  Then one write
    sequence on CASCADE_STREAM (each sealed segment a cascade; bulk 192
    rows, seal_threshold 128) on both:
    segments, ids, live bitmaps, counters and epoch equal, results within
    rtol 1e-5.  Last, cascade(flat|r32) at budgets (n,) against the exact
    flat scan on each device, within rtol 1e-5."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import engine
    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams, as_spec, make_index
    from repro_torch.knn.registry import get_impl
    from repro_torch.testing import (build_draws, fp32_near_equal,
                                     lifecycles_equal, stream_lifecycle)

    n, d, k = 384, 32, 10
    rng = np.random.default_rng(10)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((256, d)).astype(np.float32)

    def requests(idx, sp):
        s = idx.searcher(k, sp, batch_sizes=BUCKETS)
        out, start = [], 0
        for b in (1, 8, 32, 215):
            out.append(s(queries[start:start + b]))
            start += b
        return (np.concatenate([r.scores.cpu().numpy() for r in out]),
                np.concatenate([r.ids.cpu().numpy() for r in out]))

    def same(got, want, integer, what):
        (gs, gi), (ws, wi) = ((s.cpu().numpy(), i.cpu().numpy())
                              for s, i in (got, want))
        if integer:
            need(np.array_equal(gi, wi) and np.array_equal(gs, ws),
                 f"{what}: the card's integer results differ from the CPU's")
        else:
            need(fp32_near_equal(gs, gi, ws, wi, 1e-5)[0],
                 f"{what}: the card's fp32 results differ from the CPU's "
                 "beyond rtol 1e-5")

    for f, over in CASCADE_EXACT.items():
        t0 = time.perf_counter()
        spec = as_spec(f, metric="ip")
        cpu = get_impl(spec.kind).build(corpus, spec, device="cpu", **over)
        spec, kw = build_draws(f, "ip", cpu, corpus)
        card = get_impl(spec.kind).build(corpus, spec, device="cuda", **kw,
                                         **over)
        need(all(torch.equal(a.cpu(), b) for a, b in
                 zip(_store_codes(card), _store_codes(cpu))),
             f"{f}: the card's codes differ from the CPU's")
        checks = []
        if spec.kind == "cascade":
            budgets = cpu.resolve_budgets(k, None, None)
            qt = torch.from_numpy(queries)
            hc = card.head.search(qt, budgets[0])
            hw = cpu.head.search(qt, budgets[0])
            head_int = card.head.store.bits < 32 and getattr(
                card.head.store, "lpq_tables", True)
            same((hc.scores, hc.ids), (hw.scores, hw.ids), head_int,
                 f"{f} head at k={budgets[0]}")
            checks.append(f"head ({'bit-equal' if head_int else 'fp32'}) at "
                          f"k={budgets[0]}")
            ids = hw.ids
            outs = tuple(budgets[1:]) + (k,)
            for i, (a, b, out_k) in enumerate(zip(card.stage_stores,
                                                  cpu.stage_stores, outs)):
                gc = engine.refine_among(qt, a, ids, out_k, "ip")
                gw = engine.refine_among(qt, b, ids, out_k, "ip")
                same(gc[:2], gw[:2], b.bits < 32, f"{f} stage {i}")
                checks.append(f"stage {cpu.stage_specs[i]} "
                              f"({'bit-equal' if b.bits < 32 else 'fp32'})")
                ids = gw[1]
        else:
            for name in ("assign", "lo", "hi", "zero", "sigmas"):
                need(torch.equal(getattr(card.regions, name).cpu(),
                                 getattr(cpu.regions, name)),
                     f"{f}: region {name} differs")
            checks.append(f"{cpu.regions.n_regions} regions' constants")
            if spec.kind != "ivf":
                sp = SearchParams(ef_search=40)
                beam = [requests(dataclasses.replace(i, regions=None), sp)
                        for i in (card, cpu)]
                need(all(np.array_equal(a, b) for a, b in zip(*beam)),
                     f"{f}: the integer walk differs before the re-score")
                checks.append("integer walk (bit-equal)")
        for sel in (None, *FILTER_SELS):
            filt = (None if sel is None
                    else Filter.from_mask(allow_mask(n, sel, 2)))
            sp = SearchParams(nprobe=4, ef_search=40, filter=filt)
            (gs, gi), (ws, wi) = requests(card, sp), requests(cpu, sp)
            need(fp32_near_equal(gs, gi, ws, wi, 1e-5)[0],
                 f"{f} filter {sel}: the card's Searcher differs from the "
                 "CPU's beyond rtol 1e-5")
        log(f"[cascade] {f} ip {n}x{d}: built on the card and the CPU from "
            f"one set of draws: codes, {', '.join(checks)} equal; Searcher "
            f"within rtol 1e-5 unfiltered and at {FILTER_SELS}, requests of "
            f"1, 8, 32 and 215 ({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    allow = allow_mask(600, 0.25, 1)
    runs = [stream_lifecycle(make_index, CASCADE_STREAM, corpus, queries,
                             allow, (1, 8, 32, 215), bulk=192, k=k,
                             searcher_kw={"batch_sizes": BUCKETS},
                             metric="ip", device=dev, seal_threshold=128,
                             max_segments=4)
            for dev in ("cuda", "cpu")]
    diff, _exact, eq = lifecycles_equal(*runs, allow, 1e-5,
                                        integer_sources=False)
    need(diff is None, f"{CASCADE_STREAM}: the card's write sequence differs "
         f"from the CPU's: {diff}")
    c = runs[0][-1][1]
    log(f"[cascade] {CASCADE_STREAM} ip: one write sequence (seal_threshold "
        f"128, {c['seals']} seals, {c['compactions']} compactions) on the "
        f"card and the CPU: segments (cascades), ids, live bitmaps, counters "
        f"and epoch equal at 8 checkpoints, filtered Searcher within rtol "
        f"1e-5 ({eq} scores bit-equal; {time.perf_counter() - t0:.2f} s)")

    qt = torch.from_numpy(queries)
    for dev in ("cuda", "cpu"):
        exact = make_index("flat", corpus, device=dev).search(qt, k)
        casc = make_index("cascade(flat|r32)", corpus, device=dev).search(
            qt, k, SearchParams(budgets=(n,)))
        need(fp32_near_equal(casc.scores.cpu().numpy(),
                             casc.ids.cpu().numpy(),
                             exact.scores.cpu().numpy(),
                             exact.ids.cpu().numpy(), 1e-5)[0],
             f"cascade(flat|r32) at budgets ({n},) on {dev} differs from the "
             "exact flat scan")
    log(f"[cascade] cascade(flat|r32) at budgets ({n},): equal to the exact "
        f"flat scan within rtol 1e-5 on the card and on the CPU")


def cascade_recall() -> None:
    """10(b): REGION_RECALL at n=20000, 128 queries: recall (@10 for the
    cascades, @100 otherwise) against the fp32 flat arm within max(0.02,
    the reference's spread) of the reference's mean (REF_CASCADE)."""
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.knn import SearchParams, make_index

    data = {}
    for name, f, kk, over, knob, values in REGION_RECALL:
        if name not in data:
            corpus, queries, metric = synthetic.load(name, 20000, 128)
            gt = make_index("flat", corpus, metric=metric).search(
                queries, 100).ids
            data[name] = corpus, queries, metric, gt
        corpus, queries, metric, gt = data[name]
        t0 = time.perf_counter()
        idx = make_index(f, corpus, metric=metric, **over)
        build_s = time.perf_counter() - t0
        for v in values:
            res = idx.search(queries, kk, SearchParams(**{knob: v}))
            rec = recall_at_k(gt[:, :kk], res.ids)
            want, spread = REF_CASCADE[name, f, v]
            tol = max(0.02, spread)
            ok = abs(rec - want) <= tol
            log(f"[cascade] {name} 20000x{corpus.shape[1]} {metric} {f} "
                f"{knob} {v}: recall@{kk} {rec:.4f} (reference mean {want}, "
                f"spread {spread}, |diff| <= {tol}: {ok}; build "
                f"{build_s:.2f} s) | {smi()}")
            need(ok, f"recall for {name} {f} {knob} {v}: {rec:.4f} vs {want} "
                 f"+- {tol}")
        del idx


def bytes_per_query(idx, budgets) -> int:
    """benchmarks/bench_cascade.py:66-78's model bytes one query touches:
    a scan reads every stored row, a cascade adds one gathered row a
    surviving candidate a refinement stage."""
    if idx.kind == "cascade":
        return bytes_per_query(idx.head, None) + sum(
            int(b) * st.row_bytes for b, st in zip(budgets, idx.stage_stores))
    return int(idx.store.n) * int(idx.store.row_bytes)


def cascade_parts(f, idx, q, budgets, k) -> None:
    """One 256-query request of a cascade by stage: the head's plan at
    budgets[0], then each refinement stage (``engine.refine_among``) on
    the head's candidates; CUDA-event medians of 5, after the counts of
    10(c) were read."""
    from repro_torch import engine
    from repro_torch.knn import SearchParams

    head = idx.head.plan(budgets[0], SearchParams())
    parts = {f"head {idx.head.kind} k={budgets[0]}": time_ms(lambda: head(q),
                                                              5)}
    ids = head(q).ids
    for spec, st, out_k in zip(idx.stage_specs, idx.stage_stores,
                               tuple(budgets[1:]) + (k,)):
        parts[f"{spec} {ids.shape[1]} -> {out_k}"] = time_ms(
            lambda st=st, ids=ids, out_k=out_k: engine.refine_among(
                q, st, ids, out_k, idx.metric), 5)
        ids = engine.refine_among(q, st, ids, out_k, idx.metric)[1]
    log(f"[cascade] {f}: one 256-query request's parts (CUDA events, median "
        f"of 5): " + ", ".join(f"{a} {b:.3f} ms" for a, b in parts.items())
        + f" | {smi()}")


def regional_parts(f, idx, q, nprobe) -> None:
    """One 256-query request of a regional ivf by part: the coarse probe
    (B2 fp32 over the centroids) and the regional fine scoring (candidate
    gather, per-row dequantization, fp32 scores and top-k, in
    ``IVF.fine_block_rows`` query blocks); CUDA-event medians of 5."""
    import torch

    from repro_torch import engine
    from repro_torch.engine import CodeStore
    from repro_torch.knn import ivf as IVF

    cents = CodeStore.dense(idx.centroids)
    probe = lambda: engine.topk(q, cents, nprobe, idx.metric)[1]
    cand = idx.lists[probe().long()].reshape(q.shape[0], -1)
    rows = IVF.fine_block_rows(idx.store, cand.shape[1], regional=True)
    rg = idx.regions

    def fine():
        for s in range(0, q.shape[0], rows):
            engine.topk_among_regional(q[s:s + rows], idx.store, rg.scale,
                                       rg.zero, rg.assign, cand[s:s + rows],
                                       100, idx.metric)

    torch.cuda.reset_peak_memory_stats()
    fine_ms = time_ms(fine, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[cascade] {f} nprobe {nprobe}: one 256-query request's parts (CUDA "
        f"events, median of 5): probe {time_ms(probe, 5):.3f} ms, regional "
        f"fine scoring {fine_ms:.3f} ms ({-(-q.shape[0] // rows)} blocks of "
        f"{rows} queries, {cand.shape[1]} candidates a query; peak device "
        f"memory {peak:.2f} GiB) | {smi()}")


def regions_memory(idx, n: int, d: int) -> int:
    """The reference's memory formulas for a regions build: the kind's own
    (``ivf_memory`` / ``graph_memory``) plus the assignment (4 bytes a
    row) and three [R, d] f32 constant stacks, and for the graph kind its
    regional store (n x d int8 codes and 3 d f32 nominal constants)."""
    rg = idx.regions
    extra = 4 * n + 3 * rg.n_regions * d * 4
    if idx.kind == "ivf":
        return ivf_memory(idx, n, d) + extra
    return graph_memory(idx, n, d) + extra + n * d + 3 * d * 4


def cascade_path(err: dict, pc, pq) -> dict:
    """10(c): the exact fp32 ground truths first, outside the counts;
    then one run of the path (counters set to 0 before, read after) on
    phase 9's product-like 4,000,000 x 256 corpus (ip) and on the SIFT-like
    1,000,000 x 128 rows of phase 8 (synthetic.load's seed, l2): the two
    cascades at their budgets beside flat,lpq8@gaussian:3 and
    flat,lpq4 at k=10 (recall@10, memory ratio, QPS and p50 at 256-query
    requests and the mixed 1/8/32 stream, each stage row of one request,
    the model bytes a query, and bench_cascade's gate, logged); then
    REGION_IVF at nprobe 16 and 64 and REGION_GRAPH at ef_search 300
    (build seconds by part, memory against the reference's formula,
    recall@100, QPS, p50).  After the counts are read: every kernel scan
    of the run and of the ground truths against its plain version at every
    bucket (B3 under the lpq4 head and beside it, B2 int8 beside it, B2
    fp32 for the ivf probe, the graph's entry probe and both ground
    truths); B1's store
    codes (the heads, stages, the arms beside them and the regional graph's
    global store) against the plain quantize; 1,024 rows of the regional
    graph's self-join."""
    import types

    import torch

    from repro_torch import kernels
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.engine import CodeStore
    from repro_torch.kernels import fused_topk as F
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.knn import ivf as IVF
    from repro_torch.core import quant as Qz

    card = smi()
    k = 10
    n, d = pc.shape
    # the oracles run before the counted run (their scans are held
    # against the plain version with the path's, after it)
    t0 = time.perf_counter()
    flat = make_index("flat", pc, metric="ip")
    gt = flat.search(pq, k).ids
    sc, sq, sm = synthetic.load("sift", 1_000_000, 1000)
    sn, sd = sc.shape
    sflat = make_index("flat", sc, metric=sm)
    sgt = sflat.search(sq, 100).ids
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    holds = [("product flat (ground truth)", flat, pq, k),
             ("sift flat (ground truth)", sflat, sq, 100)]
    cells, b1, cascades = {}, [], {}
    kernels.reset_launch_counts()

    def serve_arm(f, idx, sp):
        s = idx.searcher(k, sp)
        ids, qps, p50, _ = serve(idx, pq, k, (256,), s)
        need(ids.shape == (pq.shape[0], k) and bool(torch.all(ids >= 0)),
             f"{f}: bad ids")
        _, mqps, mp50, _ = serve(idx, pq[:205], k, (1, 8, 32), s)
        return recall_at_k(gt, ids), qps, p50, mqps, mp50, s(pq[:256]).stats

    for f in (*CASCADE_BESIDE, *CASCADE_ARMS):
        budgets = CASCADE_ARMS.get(f)
        t0 = time.perf_counter()
        idx = make_index(f, pc, metric="ip",
                         **(CASCADE_BUILD if budgets else {}))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sp = SearchParams(budgets=budgets)
        rec, qps, p50, mqps, mp50, stats = serve_arm(f, idx, sp)
        ratio = idx.memory_bytes() / (n * d * 4)
        per_q = bytes_per_query(idx, budgets)
        cells[f] = (rec, per_q)
        stages = ""
        if budgets:
            stages = "; stages (label, candidates, bytes, bits) of one " \
                f"256-query request: {list(stats['stages'])}"
            head = idx.head
            if isinstance(head.store, CodeStore) and head.store.quantized:
                holds.append((f"{f} head", head, pq, budgets[0]))
                b1.append((f"{f} head", head.store))
            b1 += [(f"{f} stage {s}", st)
                   for s, st in zip(idx.stage_specs, idx.stage_stores)
                   if st.quantized]
            cascades[f] = idx
        else:
            holds.append((f, idx, pq, k))
            b1.append((f, idx.store))
        log(f"[cascade] product {n}x{d} ip {f}"
            f"{f' budgets {budgets}' if budgets else ''} k={k}: recall@10 "
            f"{rec:.4f} mem {ratio:.4f} QPS {qps:.1f} p50 {p50:.2f} ms "
            f"(256-query requests); mixed 1/8/32: QPS {mqps:.1f} p50 "
            f"{mp50:.2f} ms; {per_q} model bytes a query; build "
            f"{build_s:.2f} s{stages} | {card}")
        del idx
    floor_arm, ceil_arm = CASCADE_BESIDE
    floor, ceiling = cells[floor_arm][0], cells[ceil_arm][1]
    passing = [f for f in CASCADE_ARMS if cells[f][0] >= floor
               and cells[f][1] <= ceiling]
    log(f"[cascade] bench_cascade's gate (logged, not gated): recall@10 >= "
        f"{floor:.4f} ({floor_arm}) at <= {ceiling} bytes a query "
        f"({ceil_arm}): passing {passing or 'none'} "
        f"({', '.join(f'{f}: {cells[f][0]:.4f}, {cells[f][1]}' for f in CASCADE_ARMS)})")

    for f, knob, values in ((REGION_IVF, "nprobe", INDEX_NPROBE),
                            (REGION_GRAPH, "ef_search", (INDEX_EF,))):
        t0 = time.perf_counter()
        idx = make_index(f, sc, metric=sm)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mem = idx.memory_bytes()
        need(mem == regions_memory(idx, sn, sd), f"{f}: memory {mem} is not "
             f"the reference's formula's {regions_memory(idx, sn, sd)}")
        parts = ", ".join(f"{a} {b:.2f} s" for a, b in idx.build_parts.items())
        log(f"[cascade] sift {sn}x{sd} {sm} {f}: build {build_s:.2f} s "
            f"({parts}), {idx.regions.n_regions} regions, memory {mem} bytes "
            f"= {mem / (sn * sd * 4):.4f} of fp32 flat | {card}")
        for v in values:
            s = idx.searcher(100, SearchParams(**{knob: v}))
            ids, qps, p50, _ = serve(idx, sq, 100, (256,), s)
            need(ids.shape == (1000, 100) and bool(torch.all(ids >= 0)),
                 f"{f}: bad ids")
            _, mqps, mp50, _ = serve(idx, sq[:205], 100, (1, 8, 32), s)
            extra = ""
            if idx.kind == "ivf":
                width = min(v, idx.nlist) * idx.max_list
                extra = (f"; {IVF.fine_block_rows(idx.store, width, True)} "
                         "queries a regional fine-scoring block")
            log(f"[cascade] sift {f} {knob} {v}: recall@100 "
                f"{recall_at_k(sgt, ids):.4f} QPS {qps:.1f} p50 {p50:.2f} ms "
                f"(256-query requests); mixed 1/8/32: QPS {mqps:.1f} p50 "
                f"{mp50:.2f} ms{extra} | {card}")
        if idx.kind == "ivf":
            probe = (f"{f} probe", CodeStore.dense(idx.centroids),
                     max(INDEX_NPROBE))
            rivf = idx
        else:
            probe = (f"{f} entry probe", CodeStore.dense(idx.seeds),
                     min(8, idx.seeds.shape[0]))
            graph = idx
        what, store, depth = probe
        holds.append((what, types.SimpleNamespace(store=store, metric=sm), sq,
                      depth))
    run = kernels.launch_counts()
    log(f"[cascade] kernel launches on this run of the cascade / regions "
        f"path: {run} (the SIFT rows and both ground truths, before the "
        f"counted run: {gt_s:.2f} s)")
    for name in CASCADE_KERNELS:
        need(run[name] > 0, f"kernel {name} was never launched on the "
             "cascade / regions path")

    # where one 256-query request's time goes (CUDA events, median of 5)
    for f, idx in cascades.items():
        cascade_parts(f, idx, pq[:256], CASCADE_ARMS[f], k)
    for p in INDEX_NPROBE:
        regional_parts(REGION_IVF, rivf, sq[:256], p)

    # every kernel scan of this run against its plain version
    for what, idx, queries, depth in holds:
        check_scan(what, idx, queries, depth, err)
    for what, store in b1 + [(f"{REGION_GRAPH} store", graph.store)]:
        p = store.params
        x = sc if store.d == sd else pc
        plain = CodeStore.from_codes(
            R.quantize_ref(x, p.lo, p.hi, p.zero, bits=p.bits), p,
            pack=store.packed).data
        need(torch.equal(plain, store.data),
             f"{what}: codes differ from the plain quantize")
    log(f"[cascade] B1: {', '.join(w for w, _ in b1)} and the {REGION_GRAPH} "
        "store codes equal to the plain quantize")
    store = graph.store
    codes = store.data[:JOIN_CHECK_ROWS]
    q = store.encode_queries(Qz.dequantize(codes[:, : store.d], store.params))
    half = max(graph.degree // 2, 1)
    got = K.fused_topk(q, store.data, half + 1, "l2")
    want = F.fused_topk_plain(q, store.data, k=half + 1, metric="l2")
    hold("fused_topk_int8", got, want, q, store.data, half + 1, "l2", None,
         f"{REGION_GRAPH} self-join {JOIN_CHECK_ROWS} rows", err)
    log(f"[cascade] {REGION_GRAPH}: {JOIN_CHECK_ROWS} self-join rows equal "
        "to the plain version, ids and scores")
    del holds, cascades, graph, rivf, idx, flat, sflat, sc, sq, sgt, gt
    torch.cuda.empty_cache()
    return {name: run[name] for name in CASCADE_KERNELS}


# --------------------------------------------------------------------------
# phase 11: the autotuner, tuned serving and the runtime subsystem
# --------------------------------------------------------------------------

#: phase 11(b): the main path's product arms, each served by a Searcher
#: planned with the tuning table and one planned without, and the kernel
#: each must launch on both
TUNED_ARMS = {"flat,lpq8@gaussian:3": "fused_topk_int8",
              "flat,lpq4": "fused_topk4", "pq32+lpq": "fused_adc",
              "pq64x4+lpq": "fused_adc4"}
#: 256-query requests a turn (untuned, tuned, tuned, untuned)
TUNED_REQS = 8
#: rows of the index 11(b) saves and reloads (adoption is about its meta)
TUNED_SAVE_N = 100_000
#: phase 11(c): the stream kind under a maintenance thread: its bulk rows,
#: upsert rounds (one sealed segment each) and the segment bound
MAINT_ARM = "stream(flat,lpq8@gaussian:3)"
MAINT_N = 250_000
MAINT_ROUND = 8192
MAINT_ROUNDS = 4
#: 11(c)'s admission burst under an injected clock: (queries, queue depth,
#: seconds advanced first) and the CPU run's decisions for it
ADMIT_BURST = ((4, 0, 0.0), (2, 2, 0.0), (4, 0, 0.0), (1, 4, 0.0),
               (16, 0, 0.0), (8, 0, 1.0))
#: 11(a): the store whose requests time the host cost of a table lookup
#: (small, so the host's share of a request shows): rows, width, queries,
#: lookups timed, requests a turn
LOOKUP_N, LOOKUP_D, LOOKUP_Q, LOOKUP_REPS, LOOKUP_REQS = 8192, 256, 8, 2000, 50
ADMIT_EXPECT = (("admit", "ok", 4.0), ("degrade", "queue", 0.5),
                ("degrade", "budget", 1.0), ("shed", "queue", 0.0),
                ("shed", "budget", 0.0), ("admit", "ok", 8.0))


def tune_path():
    """11(a): ``autotune`` at the main path's widths and phase 4's n bucket
    (the autotuner's default workloads: 4,000,000 rows, Q=256, k=100), every
    candidate held bit-equal to its plain version before it is timed (the
    tuner raises otherwise); each entry logged with the card; the table
    written to JSON and read back with the same hash."""
    import torch

    from repro_torch.tune import TuneTable
    from repro_torch.tune import autotuner as AT

    card = smi()
    t0 = time.perf_counter()
    try:
        table = AT.autotune(verbose=True)
    except AssertionError as e:
        raise SmokeFailure(f"autotune: {e}") from None
    torch.cuda.synchronize()
    log(f"[tune] {len(table.entries)} workloads tuned in "
        f"{time.perf_counter() - t0:.1f} s, every candidate bit-equal to "
        f"the plain version | {card}")
    need(table.stamp["backend"] == "cuda"
         and table.stamp["device_kind"] == torch.cuda.get_device_name(0),
         f"table stamped {table.stamp}")
    need(len(table.entries) == len(AT.default_workloads()),
         f"{len(table.entries)} entries")
    for key, cfg in sorted(table.entries.items()):
        log(f"[tune] {key}: {cfg.impl} bq={cfg.bq} bn={cfg.bn} "
            f"chunk={cfg.chunk}: {cfg.measured_us:.1f} us, default "
            f"{cfg.default_us:.1f} us ({cfg.default_us / cfg.measured_us:.3f}"
            f"x) | {card}")
    path = ROOT / "build" / "phase11_TUNE.json"
    path.parent.mkdir(exist_ok=True)
    table.to_json(path)
    back = TuneTable.from_json(path)
    need(back.table_hash() == table.table_hash()
         and back.to_dict() == table.to_dict(),
         "the table read back from JSON differs")
    log(f"[tune] wrote {path.relative_to(ROOT)}, read back with hash "
        f"{back.table_hash()}")
    lookup_cost(table)
    return table


def lookup_cost(table) -> None:
    """11(a): the host cost of consulting the table, which every tuned
    ``engine.topk`` does: one ``lookup`` under a pinned table and under
    none, beside one whole runtime stamp (what a lookup's stamp check
    would cost if it built one), and the wall time of a small
    ``engine.topk`` request tuned and untuned, in turns (untuned, tuned,
    tuned, untuned), its results equal."""
    import torch

    from repro_torch import engine
    from repro_torch.knn import make_index
    from repro_torch.tune import TuneTable
    from repro_torch.tune import space as S
    from repro_torch.tune import table as T

    card = smi()
    g = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn(LOOKUP_N, LOOKUP_D, generator=g, device="cuda")
    q = torch.randn(LOOKUP_Q, LOOKUP_D, generator=g, device="cuda")
    store = make_index("flat,lpq8", x, metric="ip").store
    shape = ("fused_topk", "ip", 8, LOOKUP_Q, LOOKUP_N, LOOKUP_D)
    small = TuneTable(stamp=dict(table.stamp), entries=dict(table.entries))
    small.put(*shape, S.default_config(S.Workload(*shape, k=10), "cuda"))

    def per_call_us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(LOOKUP_REPS):
            fn()
        return (time.perf_counter() - t0) / LOOKUP_REPS * 1e6

    with T.pinned(small):
        hit_us = per_call_us(lambda: T.lookup(*shape))
        stamp_us = per_call_us(T.live_stamp)
    with T.pinned(None):
        none_us = per_call_us(lambda: T.lookup(*shape))
    lat = {"untuned": [], "tuned": []}
    res = {}
    for name in ("untuned", "tuned", "tuned", "untuned"):
        with T.pinned(small if name == "tuned" else None):
            for _ in range(LOOKUP_REQS):
                t0 = time.perf_counter()
                s, i, st = engine.topk(q, store, 10, "ip")
                torch.cuda.synchronize()
                lat[name].append((time.perf_counter() - t0) * 1e6)
                need(st["tuned"] is (name == "tuned"), f"tuned {st['tuned']}")
        res[name] = (s, i)
    need(all(torch.equal(a, b) for a, b in zip(res["untuned"], res["tuned"])),
         "a tuned small request differs from the untuned one")
    p50 = {n: statistics.median(v) for n, v in lat.items()}
    log(f"[tune] host cost of a table lookup: {hit_us:.2f} us with a table "
        f"pinned (hit), {none_us:.2f} us with none; one whole runtime stamp "
        f"{stamp_us:.2f} us; wall time of one {LOOKUP_Q}-query engine.topk "
        f"on {LOOKUP_N}x{LOOKUP_D} flat,lpq8 (p50 of {2 * LOOKUP_REQS} a "
        f"side, turns untuned, tuned, tuned, untuned): untuned "
        f"{p50['untuned']:.2f} us, tuned {p50['tuned']:.2f} us | {card}")


def _p50_turns(searchers: dict, q, reps: int) -> dict:
    """p50 ms of ``reps`` requests a turn, in turns untuned, tuned, tuned,
    untuned (each searcher warmed first)."""
    import torch

    lat = {name: [] for name in searchers}
    for s in searchers.values():
        s(q)
    torch.cuda.synchronize()
    for name in ("untuned", "tuned", "tuned", "untuned"):
        for _ in range(reps):
            t = time.perf_counter()
            searchers[name](q)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t) * 1e3)
    return {name: statistics.median(v) for name, v in lat.items()}


def tuned_serving(table, pc, pq) -> dict:
    """11(b): phase 9's product-like rows through each TUNED_ARMS arm, one
    Searcher planned with the table installed and one without: ids and
    scores bit-equal, stats["tuned"] and the bytes a request reads follow
    the plan's table, the arm's kernel launched by both, p50 in turns.
    Then an index saved with the table installed adopts it on load.
    Returns the built arms (11(c) serves two of them)."""
    import torch

    from repro_torch import kernels
    from repro_torch.knn import load_index, make_index
    from repro_torch.tune import table as T

    card = smi()
    n, k = pc.shape[0], 100
    q = pq[:256]
    built = {}
    for f, kname in TUNED_ARMS.items():
        t0 = time.perf_counter()
        idx = make_index(f, pc, metric="ip")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        T.clear()
        untuned = idx.searcher(k)
        T.install(table)
        tuned = idx.searcher(k)
        T.clear()                       # plans keep their snapshots
        need(tuned.tune_table is table and untuned.tune_table is None,
             f"{f}: plan-time snapshots")
        got = {}
        for name, s in (("untuned", untuned), ("tuned", tuned)):
            before = kernels.launch_counts()[kname]
            got[name] = s(q)
            torch.cuda.synchronize()
            need(kernels.launch_counts()[kname] > before,
                 f"{f}: the {name} plan did not launch {kname}")
        a, b = got["untuned"], got["tuned"]
        need(torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores),
             f"{f}: tuned results differ from untuned")
        need(b.stats["tuned"] is True and a.stats["tuned"] is False,
             f"{f}: stats tuned {a.stats['tuned']} / {b.stats['tuned']}")
        store = idx.store
        if kname.startswith("fused_adc"):
            key = ("fused_adc", "ip", store.bits, 256, n, store.m)
        else:
            key = ("packed" if store.packed else "fused_topk", "ip",
                   store.bits, 256, n, store.d)
        cfg = table.get(*key)
        need(cfg is not None and cfg.impl == "fused",
             f"{f}: no kernel entry for {key}")
        want = n * store.row_bytes * -(-256 // cfg.bq)
        need(b.stats["bytes_read"] == want,
             f"{f}: tuned bytes_read {b.stats['bytes_read']} != {want} "
             f"(bq={cfg.bq})")
        p50 = _p50_turns({"untuned": untuned, "tuned": tuned}, q, TUNED_REQS)
        log(f"[tuned] product {n}x{pc.shape[1]} ip {f} (build {build_s:.2f} "
            f"s): entry bq={cfg.bq} bn={cfg.bn}; ids and scores bit-equal to "
            f"the untuned plan; bytes a request {a.stats['bytes_read']} "
            f"untuned, {b.stats['bytes_read']} tuned; p50 of 256-query "
            f"requests (turns untuned, tuned, tuned, untuned; "
            f"{2 * TUNED_REQS} each): untuned {p50['untuned']:.3f} ms, tuned "
            f"{p50['tuned']:.3f} ms | {card}")
        built[f] = idx

    # a saved index carries the table; a load adopts it, stamp-checked
    path = ROOT / "build" / "phase11_idx.npz"
    small = make_index("flat,lpq8@gaussian:3", pc[:TUNED_SAVE_N], metric="ip")
    T.install(table)
    small.save(path)
    T.clear()
    adopted = T.COUNTERS["tune_adopted"]
    again = load_index(path)
    need(T.active() is not None
         and T.active().table_hash() == table.table_hash()
         and T.COUNTERS["tune_adopted"] == adopted + 1,
         "the reloaded index did not adopt the table")
    r0, r1 = small.search(q, k), again.search(q, k)
    need(torch.equal(r0.ids, r1.ids) and torch.equal(r0.scores, r1.scores)
         and r1.stats["tuned"] is True, "the reloaded index serves otherwise")
    T.clear()
    path.unlink()
    log(f"[tuned] {TUNED_SAVE_N}-row index saved with the table installed, "
        f"reloaded: adopted (hash {table.table_hash()}), results equal")
    return built


def runtime_path(built, pc, pq):
    """11(c): the result cache (a repeat hits, bit-identical, launching no
    kernel), the LUT cache on an eager pq32+lpq search, a maintenance thread
    compacting MAINT_ARM while this thread serves (waiting on its swap
    event), a forced full compaction, an admission burst under an injected
    clock, and the phase's telemetry summary and runtime stamp.  Returns
    the check of the compaction against a from-scratch build on
    live_items(), to run once the phase's launch counts are read (the
    oracle's build and search are not the path)."""
    import numpy as np
    import torch

    from repro_torch import engine, kernels
    from repro_torch.knn import make_index
    from repro_torch.runtime import (AdmissionController, CachedSearcher,
                                     LUTCache, MaintenanceScheduler,
                                     Telemetry, TTLLRUCache)
    from repro_torch.runtime import profile as rtprofile

    card = smi()
    k = 100
    q = pq[:256]
    dev = q.device
    tel = Telemetry(meta={"runtime": rtprofile.stamp()})

    # result tier
    cs = CachedSearcher(built["flat,lpq8@gaussian:3"].searcher(k),
                        TTLLRUCache(capacity=8))
    tr = tel.request("cache-miss")
    with tr.span("execute", device=dev):
        miss = cs(q)
    tr.finish()
    before = kernels.launch_counts()
    tr = tel.request("cache-hit")
    with tr.span("execute", device=dev):
        hit = cs(q)
    tr.finish()
    need(hit.stats["cache"] == "hit" and miss.stats["cache"] == "miss",
         "result cache: no hit on the repeat")
    need(torch.equal(hit.ids, miss.ids) and torch.equal(hit.scores,
                                                        miss.scores),
         "result cache: the hit differs from the miss")
    need(kernels.launch_counts() == before, "result cache: the hit launched "
         f"kernels ({before} -> {kernels.launch_counts()})")
    log(f"[runtime] result cache: repeat of a 256-query request hit, "
        f"bit-identical, no kernel launched; {cs.cache.stats()}")

    # LUT tier on the eager (one-shot) PQ path
    pq32 = built["pq32+lpq"]
    base = pq32.search(q, k)
    lut_cache = LUTCache(capacity=4)
    engine.set_lut_cache(lut_cache)
    try:
        r1, r2 = pq32.search(q, k), pq32.search(q, k)
    finally:
        engine.set_lut_cache(None)
    need(lut_cache.counters["misses"] == 1 and lut_cache.counters["hits"] == 1,
         f"LUT cache counters {dict(lut_cache.counters)}")
    for r in (r1, r2):
        need(torch.equal(r.ids, base.ids) and torch.equal(r.scores,
                                                          base.scores),
             "LUT cache: a cached search differs")
    log(f"[runtime] LUT cache: eager pq32+lpq search hit on the repeat, "
        f"results equal; {lut_cache.stats()}")

    # maintenance thread beside the request path
    rows = pc[:MAINT_N]
    extra = pc[MAINT_N:MAINT_N + MAINT_ROUND * MAINT_ROUNDS]
    t0 = time.perf_counter()
    idx = make_index(MAINT_ARM, rows, metric="ip", seal_threshold=MAINT_ROUND,
                     max_segments=2, auto_compact=False)
    for r in range(MAINT_ROUNDS):
        ids = np.arange(MAINT_N + r * MAINT_ROUND, MAINT_N + (r + 1) * MAINT_ROUND)
        idx.upsert(ids, extra[r * MAINT_ROUND:(r + 1) * MAINT_ROUND])
    idx.delete(np.arange(0, 1000, 7))
    torch.cuda.synchronize()
    seg0 = idx.stats()["segments"]
    need(idx.compactor.should_compact(idx.manifest.segments),
         f"{MAINT_ARM}: {seg0} segments need no compaction")
    log(f"[runtime] {MAINT_ARM} {MAINT_N}x{rows.shape[1]} + {MAINT_ROUNDS} x "
        f"{MAINT_ROUND} upserts: {seg0} segments, built in "
        f"{time.perf_counter() - t0:.2f} s")
    served = waits = 0
    t0 = time.perf_counter()
    with MaintenanceScheduler(idx, interval_s=0.01, telemetry=tel) as sched:
        while idx.compactor.should_compact(idx.manifest.segments):
            tr = tel.request(f"maint-{served}")
            with tr.span("execute", device=dev):
                res = idx.searcher(k)(q)
            tr.finish()
            need(res.ids.shape == (256, k) and bool(torch.all(res.ids >= 0)),
                 f"{MAINT_ARM}: bad ids while compacting")
            served += 1
            if sched.swapped.wait(timeout=10.0):
                sched.swapped.clear()
            waits += 1
            need(waits < 60, f"{MAINT_ARM}: no compaction reached the "
                 f"segment bound ({sched.counters})")
    need(sched.counters["maintenance_swaps"] >= 1
         and sched.counters["maintenance_errors"] == 0,
         f"maintenance: {dict(sched.counters)} {sched.last_error}")
    log(f"[runtime] maintenance thread: {sched.counters['maintenance_swaps']} "
        f"swaps in {time.perf_counter() - t0:.2f} s while {served} "
        f"256-query requests were served; {seg0} -> "
        f"{idx.stats()['segments']} segments")
    t0 = time.perf_counter()
    out = sched.run_once(force_full=True)
    torch.cuda.synchronize()
    need(out["swapped"] and idx.stats()["segments"] == 1,
         f"forced full compaction: {out}")
    compact_s, live_n = time.perf_counter() - t0, idx.n
    ext_ids, vecs = idx.live_items()
    got = idx.search(q, k)
    del idx

    def hold_compaction() -> None:
        inner = MAINT_ARM[len("stream("):-1]
        scratch = make_index(inner, vecs, metric="ip")
        want = scratch.search(q, k)
        mapped = torch.as_tensor(ext_ids, device=dev)[want.ids.long()]
        need(torch.equal(got.ids.long(), mapped)
             and torch.equal(got.scores, want.scores),
             "forced full compaction differs from a from-scratch build")
        log(f"[runtime] forced full compaction ({compact_s:.2f} s): one "
            f"segment of {live_n} live rows, ids and scores bit-equal to a "
            f"from-scratch {inner} on live_items() (built after the phase's "
            "launch counts were read)")

    # admission burst under an injected clock
    now = [0.0]
    ctrl = AdmissionController(rate_qps=10.0, burst=8.0, max_queue=4,
                               degrade_queue=2, clock=lambda: now[0],
                               counters=tel.counters)
    decisions = []
    for nq, depth, dt in ADMIT_BURST:
        now[0] += dt
        d = ctrl.admit(nq, queue_depth=depth)
        decisions.append((d.action, d.reason, d.tokens))
    need(tuple(decisions) == ADMIT_EXPECT, f"admission: {decisions}")
    log(f"[runtime] admission burst: {decisions} (as the CPU run)")
    log(f"[runtime] telemetry summary: {json.dumps(tel.summary())}")
    log(f"[runtime] counters: {json.dumps(dict(tel.counters))}")
    log(f"[runtime] stamp: {json.dumps(rtprofile.stamp())} | {card}")
    return hold_compaction


#: phase 11's kernels: the main path's int scans and the encode
PHASE11_KERNELS = ("quantize", "fused_topk_int8", "fused_topk4", "fused_adc",
                   "fused_adc4")


def phase11(pc, pq):
    """11: (a) tune outside the counts; then (b) and (c) as one run of the
    path, the counters set to 0 before and read after; then the oracle of
    (c)'s compaction.  Returns the counts and (b)'s builds, which phase 12
    serves again."""
    from repro_torch import kernels

    table = tune_path()
    kernels.reset_launch_counts()
    built = tuned_serving(table, pc, pq)
    hold_compaction = runtime_path(built, pc, pq)
    run = kernels.launch_counts()
    log(f"[phase11] kernel launches on phase 11's run: {run}")
    for name in PHASE11_KERNELS:
        need(run[name] > 0, f"kernel {name} was never launched on phase 11")
    hold_compaction()
    return run, built


# --------------------------------------------------------------------------
# phase 12: sharded plans and replicas (dist/) on one card
# --------------------------------------------------------------------------

#: 12(a): the reference's sharded parity arms and their build overrides
#: (tests/test_conformance.py:195)
SHARDED_ARMS = {
    "flat,lpq4": {},
    "ivf8,lpq8": {"kmeans_iters": 4},
    "ivf8,lpq8,regions": {"kmeans_iters": 4},
    "pq16x4,lpq8": {"kmeans_iters": 4},
    "pq16+lpq,l2": {"kmeans_iters": 4},
    "hnsw8,lpq8,regions": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq4,regions": {"n_seeds": 16},
    "stream(ivf8,lpq8)+r32": {"seal_threshold": 128, "kmeans_iters": 4},
    "cascade(flat,lpq4|r32)": {},
}
#: 12(a): arms whose card plans are also held to the CPU's sharded plans
#: (the card built from the CPU build's draws)
SHARDED_ON_CPU = ("flat,lpq4", "pq16x4,lpq8", "ivf8,lpq8")
#: 12(a)-(b): the shard counts of the meshes (["cuda:0"] * s)
SHARD_COUNTS = (1, 2, 4)
#: 12(b): product-like arms at full width, each with the kernel its shards
#: launch
SHARDED_WIDE = {"flat,lpq8@gaussian:3": "fused_topk_int8",
                "flat,lpq4+r32": "fused_topk4",
                "pq32+lpq": "fused_adc", "pq64x4+lpq": "fused_adc4"}
#: 12(b): timed 256-query requests a plan (each plan warmed first)
SHARDED_REQS = 6
#: 12(b): the SIFT-like ivf arm, its nprobe and its shard count
SHARDED_IVF, SHARDED_NPROBE, SHARDED_IVF_S = ("ivf1024,lpq8@global_minmax",
                                              16, 4)
#: 12(c): requests a two-replica set serves, and their queries each
REPLICA_REQS, REPLICA_Q = 32, 8
#: kernels phase 12's runs must launch: B1-B6
PHASE12_KERNELS = ("quantize", "fused_topk_int8", "fused_topk_fp32",
                   "fused_topk4", "fused_adc", "fused_adc4", "qmip")


def _mesh(s: int, dev: str = "cuda:0"):
    from repro_torch.dist import make_mesh

    return make_mesh((s,), ("data",), [dev] * s)


def _same(a, b) -> bool:
    import torch

    return (torch.equal(a.ids.cpu(), b.ids.cpu())
            and torch.equal(a.scores.cpu(), b.scores.cpu()))


def _counted(run: dict, fn, *args):
    """``fn(*args)`` as one run of phase 12's path: the launch counts set
    to 0 just before it and read just after (the card synchronised), and
    added into ``run``.  Returns fn's result and this run's counts.  The
    plans it is held against, and every timed repeat, run outside."""
    import torch

    from repro_torch import kernels

    kernels.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    for name, c in got.items():
        run[name] = run.get(name, 0) + c
    return out, got


def sharded_exact(run: dict) -> None:
    """12(a): every arm of SHARDED_ARMS at 4,000 x 64 (ip, k=10, 64
    queries, nprobe 8, ef_search 40), built once on the card (the stream
    arm with writes: segments and a memtable), planned on ["cuda:0"] * s
    for s in SHARD_COUNTS, unfiltered and at selectivity 0.25: ids and
    scores equal the card's unsharded plan bit for bit, and
    for SHARDED_ON_CPU also the CPU's sharded plan on the CPU's build (the
    card's build takes its draws).  Only the sharded plans count into
    ``run``.  Every failure is listed before the phase fails."""
    import numpy as np
    import torch

    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams, as_spec, make_index
    from repro_torch.knn.registry import get_impl
    from repro_torch.testing import (build_draws, build_with_writes,
                                     fp32_near_equal)

    n, d, k = 4000, 64, 10
    rng = np.random.default_rng(12)
    corpus = (rng.standard_normal((n, d)) * 0.05).astype(np.float32)
    q_cpu = torch.from_numpy(
        (rng.standard_normal((64, d)) * 0.05).astype(np.float32))
    queries = q_cpu.cuda()
    allow = rng.random(n) < 0.25
    params = {"unfiltered": SearchParams(nprobe=8, ef_search=40),
              "0.25": SearchParams(nprobe=8, ef_search=40,
                                   filter=Filter.from_mask(allow))}
    bad = []
    for f, over in SHARDED_ARMS.items():
        t0 = time.perf_counter()
        cpu = None
        if f in SHARDED_ON_CPU:
            spec = as_spec(f, metric="ip")
            cpu = get_impl(spec.kind).build(corpus, spec, device="cpu",
                                            **over)
            spec, kw = build_draws(f, "ip", cpu, corpus)
            if not kw["_given"]:            # a flat build draws nothing
                del kw["_given"]
            card = get_impl(spec.kind).build(corpus, spec, device="cuda",
                                             **kw, **over)
        elif f.startswith("stream"):
            # segments and a memtable: half the rows bulk-loaded, the rest
            # upserted, some deleted and upserted back (phase 9(a)'s way)
            card = build_with_writes(make_index, f, corpus, bulk=n // 2,
                                     chunk=700, dead=np.arange(5, 400, 7),
                                     revive=True, metric="ip", **over)
        else:
            card = make_index(f, corpus, metric="ip", **over)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = 0
        for tag, sp in params.items():
            un = card.searcher(k, sp)(queries)
            for s in SHARD_COUNTS:
                sh, _ = _counted(run, lambda: card.searcher(
                    k, sp, shards=_mesh(s))(queries))
                if not _same(un, sh):
                    ok, err = fp32_near_equal(
                        sh.scores.cpu().numpy(), sh.ids.cpu().numpy(),
                        un.scores.cpu().numpy(), un.ids.cpu().numpy(), 1e-6)
                    bad.append(f"{f} {tag} @ {s} shards: not bit-equal to "
                               f"the unsharded plan (fp32 rtol 1e-6: {ok}, "
                               f"{err})")
                if sh.stats["shards"] != s or "placement" not in sh.stats:
                    bad.append(f"{f} @ {s} shards: stats {sh.stats}")
                held += 1
                if cpu is not None:
                    c = cpu.searcher(k, sp, shards=_mesh(s, "cpu"))(q_cpu)
                    if not _same(c, sh):
                        bad.append(f"{f} {tag} @ {s} shards: the card's "
                                   "plan differs from the CPU's")
                    held += 1
        log(f"[sharded] {f} 4,000 x 64: built in {build_s:.2f} s; {held} "
            f"sharded plans held at {SHARD_COUNTS} shards, unfiltered and "
            f"at 0.25 (placement {sh.stats['placement']}, balance "
            f"{sh.stats['placement_balance']})"
            + (" and against the CPU's" if cpu is not None else ""))
        del card, cpu
    need(not bad, "12(a): " + "; ".join(bad))


def _p50(fn, q, reps: int) -> float:
    import torch

    fn(q)
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t = time.perf_counter()
        fn(q)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return statistics.median(lat)


def sharded_wide(built, pc, pq, run: dict) -> None:
    """12(b): the product-like arms of SHARDED_WIDE at 4,000,000 x 256 (ip,
    k=100; phase 11's builds where it has them) planned unsharded and on
    SHARD_COUNTS meshes: each shard launches the arm's kernel, ids and
    scores bit-equal to the unsharded plan, p50 of 256-query requests
    beside it, placement balance and merge bytes.  Then SHARDED_IVF at
    SIFT-like 10^6 x 128 (l2, nprobe SHARDED_NPROBE) on SHARDED_IVF_S
    shards, and retrieval_cand (10^6 x 128, Q=512, k=100) through
    make_retrieval_sharded on 4 shards against make_retrieval.  One
    request of each sharded plan counts into ``run``, and must launch its
    kernels: each shard its arm's, the ivf plan its B2 fp32 probe, the
    retrieval step B1 and B6 once a shard."""
    import torch

    from repro_torch.core.quant import learn_params, quantize
    from repro_torch.data import synthetic
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.launch.steps import make_retrieval, make_retrieval_sharded

    card = smi()
    k = 100
    q = pq[:256]
    for f, kname in SHARDED_WIDE.items():
        t0 = time.perf_counter()
        idx = built[f] if f in built else make_index(f, pc, metric="ip")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        un = idx.searcher(k)
        want = un(q)
        p50 = {"unsharded": _p50(un, q, SHARDED_REQS)}
        wire = {}
        for s in SHARD_COUNTS:
            plan = idx.searcher(k, shards=_mesh(s))
            got, c = _counted(run, plan, q)
            need(c[kname] >= s,
                 f"12(b) {f} @ {s} shards: {kname} not launched by each shard")
            need(_same(got, want), f"12(b) {f} @ {s} shards: not bit-equal "
                 "to the unsharded plan")
            p50[s] = _p50(plan, q, SHARDED_REQS)
            wire[s] = (got.stats["placement_balance"],
                       got.stats["merge_wire_bytes"])
        log(f"[sharded] product {pc.shape[0]}x{pc.shape[1]} ip {f} "
            f"({'phase 11 build' if f in built else f'built {build_s:.2f} s'}"
            f"): ids and scores bit-equal to the unsharded plan at "
            f"{SHARD_COUNTS} shards; p50 of 256-query requests unsharded "
            f"{p50['unsharded']:.3f} ms, "
            + ", ".join(f"{s} shards {p50[s]:.3f} ms (balance {wire[s][0]}, "
                        f"merge {wire[s][1]} B)" for s in SHARD_COUNTS)
            + f" | {card}")

    sc, sq, metric = synthetic.load("sift", 1_000_000, 256)
    t0 = time.perf_counter()
    idx = make_index(SHARDED_IVF, sc, metric=metric)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp = SearchParams(nprobe=SHARDED_NPROBE)
    un = idx.searcher(k, sp)
    want = un(sq)
    t0 = time.perf_counter()
    plan = idx.searcher(k, sp, shards=_mesh(SHARDED_IVF_S))
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    un_p50 = _p50(un, sq, SHARDED_REQS)
    got, c = _counted(run, plan, sq)
    need(c["fused_topk_fp32"] > 0, f"12(b) {SHARDED_IVF} @ {SHARDED_IVF_S} "
         "shards: the coarse probe did not launch fused_topk_fp32")
    need(_same(got, want), f"12(b) {SHARDED_IVF} @ {SHARDED_IVF_S} shards: "
         "not bit-equal to the unsharded plan")
    pl = plan.placement.summary()
    log(f"[sharded] SIFT-like 1000000x128 {metric} {SHARDED_IVF} nprobe "
        f"{SHARDED_NPROBE} (built {build_s:.2f} s): {SHARDED_IVF_S} shards "
        f"bit-equal to the unsharded plan; list blocks placed in "
        f"{plan_s:.2f} s, rows a shard {pl['rows']}, balance "
        f"{pl['balance']}, merge {got.stats['merge_wire_bytes']} B; p50 of "
        f"256-query requests unsharded {un_p50:.3f} ms, "
        f"sharded {_p50(plan, sq, SHARDED_REQS):.3f} ms | {card}")
    del idx, plan, un, sc, sq

    table_np, queries_np = retrieval_data(1_000_000, 128, 512, seed=0)
    table = torch.from_numpy(table_np).cuda()
    rq = torch.from_numpy(queries_np).cuda()
    p = learn_params(table, bits=8, scheme="absmax")
    args = (quantize(table, p), p.lo, p.hi, p.zero)
    plain = make_retrieval(True, k=k)
    sharded = make_retrieval_sharded(_mesh(4), table.shape[0] // 4, k=k)
    ws, wi = plain(rq, *args)
    (gs, gi), c = _counted(run, sharded, rq, *args)
    need(c["quantize"] == 4 and c["qmip"] == 4, "12(b) retrieval_cand: "
         f"make_retrieval_sharded launched quantize {c['quantize']} and qmip "
         f"{c['qmip']} times, not once a shard")
    need(torch.equal(ws, gs) and torch.equal(wi, gi),
         "12(b) retrieval_cand: make_retrieval_sharded differs from "
         "make_retrieval")

    def timed(step):
        return _p50(lambda x: step(x, *args), rq, SHARDED_REQS)

    log(f"[sharded] retrieval_cand 1000000x128 Q=512 k=100: 4 shards "
        f"bit-equal to make_retrieval; p50 make_retrieval "
        f"{timed(plain):.3f} ms, make_retrieval_sharded {timed(sharded):.3f}"
        f" ms | {card}")


def replica_path(built, pq, run: dict) -> None:
    """12(c): a ReplicaSet of two flat,lpq8@gaussian:3 Searchers (phase
    11's 4,000,000 x 256 build) on the card serves REPLICA_REQS requests
    of REPLICA_Q queries, each result equal to the plain Searcher's; the
    telemetry counters are logged.  The set's serving counts into
    ``run``; the plain Searcher runs after."""
    import torch

    from repro_torch.dist import ReplicaSet
    from repro_torch.runtime.telemetry import Telemetry

    idx = built["flat,lpq8@gaussian:3"]
    k = 100
    tel = Telemetry()

    def make(r):
        s = idx.searcher(k)

        def serve(qs):
            res = s(qs)
            torch.cuda.synchronize()
            return res

        return serve

    reqs = [pq[i * REPLICA_Q:(i + 1) * REPLICA_Q] for i in range(REPLICA_REQS)]

    def serve_all():
        rs = ReplicaSet(make, 2, telemetry=tel)
        futs = [rs.submit(r, queries=REPLICA_Q) for r in reqs]
        got = [f.result(timeout=300) for f in futs]
        rs.close()
        return got

    t0 = time.perf_counter()
    got, c = _counted(run, serve_all)
    wall = time.perf_counter() - t0
    need(c["fused_topk_int8"] >= REPLICA_REQS, "12(c): the replicas "
         f"launched fused_topk_int8 {c['fused_topk_int8']} times for "
         f"{REPLICA_REQS} requests")
    plain = idx.searcher(k)
    for i, (r, res) in enumerate(zip(reqs, got)):
        need(_same(res, plain(r)), f"12(c): request {i} served by the "
             "replica set differs from the plain Searcher's")
    counters = {key: v for key, v in tel.counters.items()
                if key.startswith("replica") or key == "requests"}
    log(f"[replicas] two flat,lpq8@gaussian:3 replicas on one card served "
        f"{REPLICA_REQS} requests of {REPLICA_Q} queries in {wall:.3f} s, "
        f"each equal to the plain Searcher's; counters {counters}; "
        f"execute {tel.percentiles('replica0/execute')} / "
        f"{tel.percentiles('replica1/execute')}; queue wait "
        f"{tel.percentiles('replica0/queue_wait')} / "
        f"{tel.percentiles('replica1/queue_wait')} | {smi()}")


def phase12(built, pc, pq) -> dict:
    """12: (a) the exactness matrix at 4,000 x 64, then (b) full width and
    (c) replicas.  The path's runs are the sharded plans' requests and the
    replica set's serving, each counted with the counters set to 0 just
    before it and read just after (``_counted``); the unsharded and plain
    plans they are held against, and the timed repeats, run outside those
    windows.  B1-B6 must each have launched on the path's runs."""
    from repro_torch import kernels

    run = dict.fromkeys(kernels.launch_counts(), 0)
    t0 = time.perf_counter()
    sharded_exact(run)
    log(f"[sharded] 12(a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_wide(built, pc, pq, run)
    log(f"[sharded] 12(b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    replica_path(built, pq, run)
    log(f"[sharded] 12(c) {time.perf_counter() - t0:.1f} s")
    log(f"[phase12] kernel launches on phase 12's sharded and replica runs: "
        f"{run}")
    for name in PHASE12_KERNELS:
        need(run[name] > 0, f"kernel {name} was never launched on phase 12")
    return run


def table2() -> None:
    from repro_torch.core.preserve import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.knn import make_index

    for (name, f), want in TABLE2.items():
        corpus, queries, metric = synthetic.load(name, 20000, 128)
        gt = make_index("flat", corpus, metric=metric).search(queries, 100).ids
        idx = make_index(f, corpus, metric=metric)
        rec = recall_at_k(gt, idx.search(queries, 100).ids)
        ok = abs(rec - want) <= 0.02
        log(f"[table2] {name} {f} {metric}: recall@100 {rec:.4f} (reference "
            f"{want}, |diff| <= 0.02: {ok}) | {smi()}")
        need(ok, f"Table 2 recall for {name} {f}: {rec:.4f} vs {want}")
    for (name, f), (want, spread) in REF_PQ.items():
        corpus, queries, metric = synthetic.load(name, 20000, 128)
        gt = make_index("flat", corpus, metric=metric).search(queries, 100).ids
        idx = make_index(f, corpus, metric=metric)
        rec = recall_at_k(gt, idx.search(queries, 100).ids)
        tol = max(0.03, spread)
        ok = abs(rec - want) <= tol
        log(f"[table2] {name} {f} {metric}: recall@100 {rec:.4f} (reference "
            f"mean {want}, spread {spread}, |diff| <= {tol}: {ok}) | {smi()}")
        need(ok, f"PQ recall for {name} {f}: {rec:.4f} vs {want} +- {tol}")


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (sets the fp32 TF32 switches)
    from repro_torch.kernels import _build

    card = smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    err = dict.fromkeys((*MAIN_KERNELS, *QSCORE), 0.0)
    clock = [time.perf_counter()] * 2

    def mark(label: str) -> None:
        now = time.perf_counter()
        log(f"[time] {label}: {now - clock[1]:.1f} s ({now - clock[0]:.1f} s "
            "since the start)")
        clock[1] = now

    try:
        info = _build.build_all()
        log(f"[build] {info['seconds']:.1f} s for {info['built'] or 'nothing (cached)'}"
            f" -> {info['dir']}")
        for name, text in info["logs"].items():
            for line in text.splitlines():
                if "registers" in line or "error" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
        mark("build")
        check_kernels(err)
        check_adc()
        check_any_k(err)
        check_qscore(err)
        timing = time_kernels(err)
        timing.update(time_adc())
        timing.update(time_qscore(err))
        mark("phase 3")
        counts = main_path(err)
        for path in (retrieval_path(err), ops_path()):
            for name, c in path.items():
                counts[name] = counts.get(name, 0) + c
        table2()
        retrieval_recall()
        mark("phases 4-6")
        graph_exact()
        for name, c in graph_path().items():
            counts[name] += c
        mark("phase 7")
        index_exact()
        index_recall()
        for name, c in index_path(err).items():
            counts[name] += c
        mark("phase 8")
        filter_exact()
        mark("phase 9(a)")
        from repro_torch.data import synthetic

        pc, pq, _ = synthetic.load("product", 4_000_000, 1000)
        phase9 = dict.fromkeys(counts, 0)
        for part, path in (("9(b)", filter_path), ("9(c)", stream_path)):
            for name, c in path(err, pc, pq).items():
                counts[name] += c
                phase9[name] += c
            mark(f"phase {part}")
        log(f"[phase9] kernel launches on phase 9's runs: {phase9}")
        for name in MAIN_KERNELS:
            need(phase9[name] > 0, f"kernel {name} was never launched on "
                 "phase 9's runs")
        cascade_exact()
        mark("phase 10(a)")
        cascade_recall()
        mark("phase 10(b)")
        for name, c in cascade_path(err, pc, pq).items():
            counts[name] += c
        mark("phase 10(c)")
        run, built = phase11(pc, pq)
        for name, c in run.items():
            counts[name] = counts.get(name, 0) + c
        mark("phase 11")
        for name, c in phase12(built, pc, pq).items():
            counts[name] = counts.get(name, 0) + c
        del pc, pq, built
        mark("phase 12")
        log(f"[kernels] C6: largest fp32 |score - float64| / row scale over "
            f"every check: kernel {FP32_ERR['kernel']:.3e}, plain version "
            f"{FP32_ERR['plain']:.3e} (each check gates the kernel at 1e-5)")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    sources = {"quantize": ("src/repro_torch/csrc/quantize.cu",
                            "src/repro/kernels/quantize.py:39"),
               "fused_topk_int8": ("src/repro_torch/csrc/fused_topk.cu",
                                   "src/repro/kernels/fused_topk.py:172"),
               "fused_topk_fp32": ("src/repro_torch/csrc/fused_topk.cu",
                                   "src/repro/kernels/fused_topk.py:172"),
               "fused_topk4": ("src/repro_torch/csrc/fused_topk.cu",
                               "src/repro/kernels/fused_topk.py:197"),
               "fused_adc": ("src/repro_torch/csrc/adc.cu",
                             "src/repro/kernels/adc.py:90"),
               "fused_adc4": ("src/repro_torch/csrc/adc.cu",
                              "src/repro/kernels/adc.py:116"),
               **{name: ("src/repro_torch/csrc/qscore.cu", rep)
                  for name, rep in QSCORE.items()}}
    rows = []
    for name, (src, rep) in sources.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts[name],
                     "max_abs_err": err[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "shape": t["shape"], "bound_formula": t["bound_formula"]})
    log(json.dumps({"kernels": rows}))
    log(smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

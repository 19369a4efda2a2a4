#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase at full size, one card

Phases (each prints its lines; any failure exits non-zero):

  1. device   card name, power limit (nvidia-smi)
  2. build    nvcc builds every kernel in src/repro_torch/csrc (timed)
  3. kernels  each kernel against its plain PyTorch version on the card at
              ragged shapes (B1, the int arms of B2/B3 and the ADC kernels
              B4/B5 bit-equal, B2 fp32 within rtol 1e-5 with ids equal
              outside near-ties), then each kernel's time at its main-path
              shape (B1-B3: 4,000,000 x 256, one 256-query bucket, k=100; B4:
              pq32 and B5: pq64x4 codes of 4,000,000 rows, 256 queries,
              k=100) beside the plain version's, the library yardstick's and
              the bound, with its result there held against the plain
              version's and the yardstick's scores
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

Output: one JSON line of kernel records (times and bound at each record's
``shape``, launches from phase 4), then the card's name and power
limit, then the last line ``{"ok": true, "device": {...}}``.  With no CUDA
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

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_INT8 = 1.979e15        # dense int8 tensor-core ops/s
PEAK_FP32 = 67e12           # fp32 CUDA-core FLOP/s
PEAK_INT32 = 67e12          # int32 CUDA-core adds/s (the ADC gather-sum)

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


def _check_fp32(q, x, k, metric, mask, got, want):
    """fp32: scores within rtol 1e-5 of the plain version's at every rank,
    and every returned id's own score (recomputed in float64) within the
    same tolerance of the score returned beside it — so ids can differ
    from the plain version's only inside near-tie groups."""
    import torch

    (gs, gi), (ws, wi) = got, want
    valid = wi >= 0
    need(torch.equal(gi >= 0, valid), "fp32: sentinel slots differ")
    need(bool(torch.all(gs[~valid] == ws[~valid])), "fp32: sentinel scores differ")
    scale = torch.where(valid, ws.abs(), 0).amax(dim=1, keepdim=True) + 1.0
    tol = 1e-5 * scale
    need(bool(torch.all(((gs - ws).abs() <= tol)[valid])),
         "fp32 scores beyond rtol 1e-5 of the plain version's")
    ids = gi.clamp_min(0).long()
    q64, rows = q.double(), x[ids].double()            # rows [Q, k, d]
    dot = torch.einsum("qd,qkd->qk", q64, rows)
    own = dot if metric == "ip" else -((q64 * q64).sum(1, keepdim=True)
                                      + (rows * rows).sum(2) - 2 * dot)
    need(bool(torch.all(((own - gs.double()).abs() <= tol.double())[valid])),
         "fp32: a returned id's own score disagrees with its returned score")
    if mask is not None:
        need(bool(torch.all(mask[ids][valid] != 0)), "fp32: a masked row returned")
    return int((gi != wi).sum())


KERNEL_OF = {"int8": "fused_topk_int8", "fp32": "fused_topk_fp32",
             "int4": "fused_topk4"}
ADC_KERNELS = ("fused_adc", "fused_adc4")


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
    swaps = _check_fp32(q, x, k, metric, mask, got, want)
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
        ds = {"int8": (64, 128, 256, 257), "fp32": (64, 128, 256),
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
    # device time of pass 1 (split) and pass 2 (merge)
    dev_ms = device_ms(lambda: F.fused_topk_cuda(qc, codes, k=k, metric="ip"),
                       ("split_topk_kernel", "merge_topk_kernel"))
    total = sum(dev_ms.values()) or 1.0
    log(f"[timing] fused_topk_int8 Q={Q} k={k} device time per call (profiler, "
        f"3 calls): split {dev_ms['split_topk_kernel']:.4f} ms "
        f"({dev_ms['split_topk_kernel'] / total:.1%}), merge "
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
        split = device_ms(kern, ("adc_split_kernel", "merge_topk_kernel"))
        log(f"[timing] {name} {shape}: kernel {ms:.4f} ms (median of {REPS}), "
            f"plain {pm:.4f} ms, library {lm:.4f} ms, bound "
            f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}: "
            f"{out[name]['bound_formula']}), roofline "
            f"{out[name]['bound_ms'] / ms:.4f}; device time per call "
            f"(profiler): split {split['adc_split_kernel']:.4f} ms, merge "
            f"{split['merge_topk_kernel']:.4f} ms | {smi()}")
        for qn in (1, 32):
            lq = lut[:qn].contiguous()
            ms1 = time_ms(lambda: K.fused_adc_topk(lq, payload, k,
                                                   packed=packed), REPS)
            b1 = (payload.numel() + lq.numel()) / PEAK_BYTES * 1e3
            o1 = qn * N * m / PEAK_INT32 * 1e3
            log(f"[timing] {name} Q={qn} N={N} M={m} k={k}: kernel {ms1:.4f} "
                f"ms, bound {max(b1, o1):.4f} ms | {smi()}")
        del lut, codes, payload
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
    log(f"[main] kernel launches on the main path: {counts}")
    for kname, c in counts.items():
        need(c > 0, f"kernel {kname} was never launched on the main path")
    return counts


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
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (sets the fp32 TF32 switches)
    from repro_torch.kernels import _build

    card = smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    err = dict.fromkeys(("quantize", *KERNEL_OF.values(), *ADC_KERNELS), 0.0)
    try:
        info = _build.build_all()
        log(f"[build] {info['seconds']:.1f} s for {info['built'] or 'nothing (cached)'}"
            f" -> {info['dir']}")
        for name, text in info["logs"].items():
            for line in text.splitlines():
                if "registers" in line or "error" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
        check_kernels(err)
        check_adc()
        timing = time_kernels(err)
        timing.update(time_adc())
        counts = main_path(err)
        table2()
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
                              "src/repro/kernels/adc.py:116")}
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

"""Time probe variants of the fused-scan source (B2 fp32, or B2 int8 with
``--int8``) on one GPU: the kernels of a ``fused_topk.cu`` rebuilt with a
few lines changed, launched directly through ``rt_fused_topk`` (no Python
wrapper inside the clock), beside the library yardstick split into its
two halves.

    python scripts/scan_probe.py <fused_topk.cu> <variant> [<variant> ...]
    python scripts/scan_probe.py --int8 <fused_topk.cu> <variant> [...]

The source's directory must hold its ``topk_common.cuh``.  Variants of
the fp32 scan as ``split_topk_kernel`` ran it (before the register-tiled
kernel, e.g. ``git show 2832eec:src/repro_torch/csrc/fused_topk.cu``):
  as_is        the source unchanged
  dots_only    the dots kept, the insert rounds predicated off on the data
  upkeep_only  the dot loop removed; each score is a cheap hash of (query,
               row), so the running top-k sees as many inserts as on
               random data
Variants of the register-tiled kernel (``f32_topk_kernel``):
  as_is        the source unchanged
  dots_only    the epilogue predicated off on the data
  upkeep_only  the dot loop removed, hashed scores as above (a Weyl
               sequence along the rows: more inserts than random data)
  pipe_only    the dot loop and the epilogue removed: the copies and
               barriers alone
  lb1          one block an SM (launch bounds free up to 255 registers)
  ring_16x3, ring_32x2
               a ring of 3 stages; 32 floats a stage at every query tile
  q_once, x_once
               the query (row) operands of a stage's first 4 floats reused
               for all 16, so the compiler can load them once a stage: how
               much the broadcast query loads (the row loads) cost
  unroll1      the loop over a stage's floats not unrolled

Corpus 4,000,000 x 256 N(0, 1) fp32, 256 queries (and 1 query), k=100,
ip, seed 7; each time is the median of 20 launches by CUDA events after
3 warm calls.  ``as_is`` is checked against the plain version's scores
(rtol 1e-5); the other variants' output is not meaningful.  Also prints
the yardstick's halves: ``torch.matmul`` (cuBLAS SGEMM, TF32 off) into
the [256, N] matrix alone, and ``torch.topk`` of that matrix alone, and
the SM clock and power nvidia-smi reads while ``as_is`` and the SGEMM run
100 times back to back.  Builds into build/scan_probe/.

With ``--int8``: variants of B2 int8 as ``split_topk_kernel`` ran it
(before ``i8_topk_kernel``; e.g. ``git show 394f8eb:src/repro_torch/csrc/
fused_topk.cu``), or of ``i8_topk_kernel`` where the source has it:
  as_is        the source unchanged
  dots_only    the dots kept, the top-k upkeep predicated off on the data
  upkeep_only  the dot loop removed; each int score a hash of (query, row)
  pipe_only    the dots and the upkeep removed: the loads and barriers
  sort_twice   each list sorted once more after its compaction: what the
               sorts cost (the new kernel only)
Corpus 4,000,000 x 256 random int8 codes in [-128, 128), 256, 32 and 1
queries, k = 10, 100 and 400, ip, seed 7; ``as_is`` is checked bit for
bit against the library's scores.  For the new kernel, ``as_is`` also
runs Q=1 at 132, 264 and 528 corpus splits (pass 2 merges splits x k
keys), and Q=32 / 256 at blocks of 8, 16 and 32 queries.  Then a
``torch.amax`` over the code bytes (what one read of them costs), and the
yardstick's halves: ``torch._int_mm`` (int8 tensor cores, exact int32
sums) into the [256, N] matrix alone, ``torch.topk`` of that matrix
alone, and both.
"""

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "scan_probe"
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: hashed score of (query, row) in [0, 1): as random as real scores
HASH = ("__uint_as_float(0x3f800000u | (((unsigned)({row}) * 2654435761u "
        "^ (unsigned)({q}) * 40503u) >> 9)) - 1.0f")

#: hashed int score of (query, row): distinct, in [0, 2^23)
HASH_I = ("(int)((((unsigned)({row}) * 2654435761u) ^ ((unsigned)({q}) * "
          "40503u)) >> 9)")

#: variant -> [(text in the source, replacement)], split_topk_kernel form
OLD = {
    "as_is": [],
    "dots_only": [
        ("        if (ok_row && q_base + qi < Q)\n          offer(",
         "        if (ok_row && q_base + qi < Q && acc[i][j] == 1234.5f)\n"
         "          offer("),
        ("      compact(buf, thresh, cnt, need, BQ, cap, k, cap - ROW_LANES);\n"
         "    }\n  }\n\n  flush_partial",
         "    }\n  }\n\n  flush_partial")],
    "upkeep_only": [
        ("for (int c0 = 0; c0 < W; c0 += DK) {",
         "for (int c0 = 0; c0 < 0; c0 += DK) {"),
        ("      for (int j = 0; j < TR; ++j) acc[i][j] = 0;",
         "      for (int j = 0; j < TR; ++j) acc[i][j] = (Acc)(" +
         HASH.format(row="t0 + lane + j * ROW_LANES", q="q_base + qg * TQ + i")
         + ");")],
}
#: the same for f32_topk_kernel
NEW = {
    "as_is": [],
    "dots_only": [("const bool pass = ok_row[j] && key > thr;",
                   "const bool pass = ok_row[j] && key > thr && "
                   "acc[i][j] == 1234.5f;")],
    "upkeep_only": [
        ("for (int dd = 0; dd < DKF; dd += 4) {",
         "for (int dd = 0; dd < 0; dd += 4) {"),
        ("        for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;",
         "        for (int j = 0; j < TR; ++j) acc[i][j] = " +
         HASH.format(row="t0 + row_of(j)", q="q_base + query_of(i)") + ";")],
    "pipe_only": [("for (int dd = 0; dd < DKF; dd += 4) {",
                   "for (int dd = 0; dd < 0; dd += 4) {"),
                  ("    if (c != n_chunks - 1) continue;",
                   "    continue;")],
    "lb1": [("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)")],
    "ring_16x3": [("static constexpr int STAGES = 2;",
                   "static constexpr int STAGES = 3;")],
    "ring_32x2": [("DK = TQ >= 4 ? 16 : 32;", "DK = 32;")],
    "q_once": [("        qv[i] = *reinterpret_cast<const float4*>(qs + query_of(i) * FROW + dd);",
                "        qv[i] = *reinterpret_cast<const float4*>(qs + query_of(i) * FROW);")],
    "x_once": [("            *reinterpret_cast<const float4*>(xs + row_of(j) * FROW + dd);",
                "            *reinterpret_cast<const float4*>(xs + row_of(j) * FROW);")],
    "unroll1": [("#pragma unroll\n    for (int dd = 0; dd < DKF; dd += 4) {",
                 "#pragma unroll 1\n    for (int dd = 0; dd < DKF; dd += 4) {")],
}


#: B2 int8 as split_topk_kernel ran it (``--int8`` on the parent's source)
I8_DOTS_ONLY = [
    ("        if (ok_row && q_base + qi < Q)\n          offer(",
     "        if (ok_row && q_base + qi < Q && acc[i][j] == 1234567)\n"
     "          offer("),
    OLD["dots_only"][1]]
I8_OLD = {
    "as_is": [],
    "dots_only": I8_DOTS_ONLY,
    "upkeep_only": [
        ("for (int c0 = 0; c0 < W; c0 += DK) {",
         "for (int c0 = 0; c0 < 0; c0 += DK) {"),
        ("      for (int j = 0; j < TR; ++j) acc[i][j] = 0;",
         "      for (int j = 0; j < TR; ++j) acc[i][j] = " +
         HASH_I.format(row="t0 + lane + j * ROW_LANES", q="q_base + qg * TQ + i")
         + ";")],
    "pipe_only": I8_DOTS_ONLY + [
        ("#pragma unroll 4\n      for (int w = 0; w < DK; ++w) {",
         "#pragma unroll 4\n      for (int w = 0; w < 0; ++w) {")],
}
#: B2 int8 as i8_topk_kernel runs it (markers in the source: the k-step
#: loop of the dots, the accumulator reset and the epilogue's vote)
I8_VOTE = "if (!__any_sync(FULL, any)) continue;"
I8_NO_VOTE = ("if (!__any_sync(FULL, any && acc[0][0][0] == 1234567)) "
              "continue;")
I8_NO_DOTS = ("for (int kk = 0; kk < I8_KC / 32; ++kk) {",
              "for (int kk = 0; kk < 0; ++kk) {")
I8_NEW = {
    "as_is": [],
    "dots_only": [(I8_VOTE, I8_NO_VOTE)],
    "upkeep_only": [
        I8_NO_DOTS,
        ("for (int e = 0; e < 4; ++e) acc[0][mi][e] = acc[1][mi][e] = 0;",
         "for (int e = 0; e < 4; ++e) acc[1][mi][e] = 0, acc[0][mi][e] = " +
         HASH_I.format(row="t0 + mi * 16 + g + (e >> 1) * 8",
                       q="q_base + warp * 8 + 2 * t4 + (e & 1)") + ";")],
    "pipe_only": [I8_NO_DOTS, (I8_VOTE, I8_NO_VOTE)],
    "sort_twice": [("      warp_compact(lists + (size_t)l * cap, n, thr, cap, k, lane);\n",
                    "      warp_compact(lists + (size_t)l * cap, n, thr, cap, k, lane);\n"
                    "      warp_sort_desc(lists + (size_t)l * cap, cap, lane);\n")],
}


def build(path: Path, names: list[str], int8: bool = False):
    source = path.read_text()
    new = ("i8_topk_kernel" if int8 else "f32_topk_kernel") in source
    table = (I8_NEW if new else I8_OLD) if int8 else (NEW if new else OLD)
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(path.parent / "topk_common.cuh", OUT / "topk_common.cuh")
    procs = {}
    for name in names:
        text = source
        for old, rep in table[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, rep)
        tag = ("i8_" if int8 else "") + ("new" if new else "old")
        cu = OUT / f"{tag}_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        lib = ctypes.CDLL(str(OUT / f"{tag}_{name}.so"))
        fn = lib.rt_fused_topk
        n_args = len(re.search(r"rt_fused_topk\(([^)]*)\)", source)
                     .group(1).split(","))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if n_args == 17:       # kind, l2, bq, cap, q0, q1, x, mask, part, ...
            fn.argtypes = [I, I, I, I, P, P, P, P, P, P, P, I, L, I, I, I, P]
        else:                  # ... part, gbuf, mbuf, out_s, out_i, ...
            fn.argtypes = [I, I, I, I, P, P, P, P, P, P, P, P, P,
                           I, L, I, I, I, P]
        fn.restype = I
        if hasattr(lib, "rt_i8_blocks_per_sm"):
            fn.occupancy = lib.rt_i8_blocks_per_sm
            fn.occupancy.argtypes = [I, I, I, I, I]
            fn.occupancy.restype = I
        libs[name] = (fn, n_args == 17, new)
    return libs


def median_ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def clocks(fn, n=100):
    """The SM clock and power nvidia-smi reads every 100 ms while ``fn``
    runs n times back to back: (min, median, max) of each."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate()
    rows = [[float(v) for v in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]
    rows = rows[2:-1] or rows               # the samples inside the window
    mhz = sorted(r[0] for r in rows)
    watt = sorted(r[1] for r in rows)
    return (f"SM clock {mhz[0]:.0f}/{statistics.median(mhz):.0f}/{mhz[-1]:.0f}"
            f" MHz, power {watt[0]:.0f}/{statistics.median(watt):.0f}/"
            f"{watt[-1]:.0f} W (min/median/max of {len(rows)} samples)")


def launcher(fn, old: bool, q, x, k):
    """A closure launching ``fn`` with the layout its source expects: the
    parent's (BQ 16 / 4, cap next_pow2(2k + 64), 528 blocks) for the old
    ABI, ``kernels.fused_topk.layout`` for the new one."""
    from repro_torch.kernels import fused_topk as F

    Q, N = q.shape[0], x.shape[0]
    dev = x.device
    st = torch.cuda.current_stream().cuda_stream
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if old:
        cap = 1 << (2 * k + 63).bit_length()
        bq = 4 if Q <= 4 or cap > 1024 else (16 if cap <= 512 else 8)
        splits = max(1, min(-(-528 // -(-Q // bq)), -(-N // 2048), 65535))
        part = torch.empty(Q * splits * k, dtype=torch.int64, device=dev)

        def call():
            rc = fn(0, 0, bq, cap, q.data_ptr(), None, x.data_ptr(), None,
                    part.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), Q, N,
                    x.shape[1], k, splits, st)
            if rc:
                raise SystemExit(f"CUDA error {rc}")
    else:
        lay = F.layout(F.KIND_F32, Q, N, k)
        part = torch.empty(Q * lay.splits * k, dtype=torch.int64, device=dev)
        gbuf = (torch.empty(lay.gbuf_keys, dtype=torch.int64, device=dev)
                if lay.gbuf_keys else None)

        def call():
            rc = fn(0, 0, lay.bq, lay.cap, q.data_ptr(), None, x.data_ptr(),
                    None, part.data_ptr(),
                    None if gbuf is None else gbuf.data_ptr(), None,
                    out_s.data_ptr(), out_i.data_ptr(), Q, N, x.shape[1], k,
                    lay.splits, st)
            if rc:
                raise SystemExit(f"CUDA error {rc}")
    return call, out_s


def i8_launcher(fn, new: bool, q, x, k, splits=None):
    """A closure launching B2 int8 ip with the layout its source expects:
    ``layout`` for ``i8_topk_kernel``, else the parent's int layout (the
    one B3 keeps: ``query_tile``, ``split_cap``, ``n_splits``)."""
    from repro_torch.kernels import fused_topk as F

    Q, N = q.shape[0], x.shape[0]
    dev = x.device
    st = torch.cuda.current_stream().cuda_stream
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if new:
        lay = F.layout(F.KIND_I8, Q, N, k, x.shape[1])
        bq, cap, gkeys = lay.bq, lay.cap, lay.gbuf_keys
        splits = splits or lay.splits
        occ = fn.occupancy(0, bq, cap, int(gkeys > 0), x.shape[1])
        print(f"  Q={Q} k={k}: {bq} queries a block, {splits} splits, "
              f"{occ} blocks an SM by the occupancy API (layout: "
              f"{F.i8_blocks_per_sm(bq, cap, gkeys > 0, x.shape[1])})",
              flush=True)
    else:
        bq, cap, splits = F.query_tile(k, Q), F.split_cap(k), F.n_splits(Q, N, k)
        gkeys = 0 if F.buffers_in_shared(k) else -(-Q // bq) * splits * bq * cap
    part = torch.empty(Q * splits * k, dtype=torch.int64, device=dev)
    gbuf = torch.empty(gkeys, dtype=torch.int64, device=dev) if gkeys else None

    def call():
        rc = fn(1, 0, bq, cap, q.data_ptr(), None, x.data_ptr(), None,
                part.data_ptr(), None if gbuf is None else gbuf.data_ptr(),
                None, out_s.data_ptr(), out_i.data_ptr(), Q, N, x.shape[1], k,
                splits, st)
        if rc:
            raise SystemExit(f"CUDA error {rc}")
    return call, out_s


def main_int8(path: str, names: list[str]):
    libs = build(Path(path), names, int8=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    N, d = 4_000_000, 256
    x = torch.randint(-128, 128, (N, d), generator=g, device="cuda",
                      dtype=torch.int8)
    qs = torch.randint(-128, 128, (256, d), generator=g, device="cuda",
                       dtype=torch.int8)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    ks = (10, 100, 400)
    want = {}
    for Q in (256, 32, 1):
        s = torch._int_mm(qs[:Q].repeat(17, 1)[:max(Q, 17)], x.T)[:Q] \
            if Q < 17 else torch._int_mm(qs[:Q], x.T)
        for k in ks:
            want[Q, k] = torch.topk(s, k, dim=1).values.float()
        del s
    for name, (fn, _, new) in libs.items():
        for k in ks:
            row = []
            for Q in (256, 32, 1):
                call, out_s = i8_launcher(fn, new, qs[:Q].contiguous(), x, k)
                ms = median_ms(call)
                tag = ""
                if name == "as_is":
                    tag = (" =library" if torch.equal(out_s, want[Q, k])
                           else " DIFFERS")
                row.append(f"Q={Q}: {ms:.4f} ms{tag}")
            print(f"{path} int8 {name} k={k} | " + "; ".join(row) +
                  f" | {card}", flush=True)
    if "as_is" in libs and libs["as_is"][2]:
        from repro_torch.kernels import fused_topk as F

        # the Q=1 scan at other split counts (pass 2 merges splits x k keys)
        q1 = qs[:1].contiguous()
        for sp in (132, 264, 528):
            call, _ = i8_launcher(libs["as_is"][0], True, q1, x, 100, sp)
            print(f"as_is Q=1 k=100 at {sp} splits: {median_ms(call):.4f} ms",
                  flush=True)
        # Q=32 and Q=256 at each query tile (blocks of 8, 16, 32 queries)
        tile = F.i8_query_tile
        for bq in (8, 16, 32):
            F.i8_query_tile = lambda q, bq=bq: min(bq, tile(q))
            for Q, k in ((32, 100), (256, 100), (256, 400)):
                call, _ = i8_launcher(libs["as_is"][0], True,
                                      qs[:Q].contiguous(), x, k)
                print(f"as_is Q={Q} k={k} at {bq} queries a block: "
                      f"{median_ms(call):.4f} ms", flush=True)
        F.i8_query_tile = tile
    if "as_is" in libs:
        call, _ = i8_launcher(libs["as_is"][0], libs["as_is"][2], qs, x, 100)
        print(f"as_is Q=256 k=100 under load: {clocks(call)}", flush=True)
    rd = median_ms(lambda: torch.amax(x.view(torch.int32)))
    print(f"read-only reference: torch.amax over the {N * d} code bytes "
          f"{rd:.4f} ms (bound {N * d / 3.35e9:.4f} ms) | {card}", flush=True)
    s = torch._int_mm(qs, x.T)
    mm = median_ms(lambda: torch._int_mm(qs, x.T))
    for k in ks:
        tk = median_ms(lambda: torch.topk(s, k, dim=1))
        both = median_ms(lambda: torch.topk(torch._int_mm(qs, x.T), k, dim=1))
        print(f"yardstick int8 Q=256 N={N} d={d} k={k}: _int_mm alone "
              f"{mm:.4f} ms, torch.topk alone {tk:.4f} ms, both {both:.4f} ms"
              f" | {card}", flush=True)


def main():
    if sys.argv[1] == "--int8":
        return main_int8(sys.argv[2], sys.argv[3:])
    libs = build(Path(sys.argv[1]), sys.argv[2:])
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    N, d, k = 4_000_000, 256, 100
    x = torch.randn(N, d, generator=g, device="cuda")
    qs = torch.randn(256, d, generator=g, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    want = {}
    for Q in (256, 1):
        s = qs[:Q] @ x.T
        want[Q] = torch.topk(s, k, dim=1).values
        del s
    for name, (fn, old, _) in libs.items():
        row = []
        for Q in (256, 1):
            call, out_s = launcher(fn, old, qs[:Q].contiguous(), x, k)
            ms = median_ms(call)
            tag = ""
            if name == "as_is":
                tol = 1e-5 * (want[Q].abs().amax(1, keepdim=True) + 1)
                tag = (" =plain" if bool(torch.all((out_s - want[Q]).abs()
                                                   <= tol)) else " DIFFERS")
            row.append(f"Q={Q}: {ms:.4f} ms{tag}")
        print(f"{sys.argv[1]} {name} | " + "; ".join(row) + f" | {card}",
              flush=True)
    if "as_is" in libs:
        call, _ = launcher(*libs["as_is"][:2], qs, x, k)
        print(f"as_is Q=256 under load: {clocks(call)}", flush=True)
    s = torch.empty((256, N), dtype=torch.float32, device="cuda")
    print("SGEMM under load: "
          f"{clocks(lambda: torch.matmul(qs, x.T, out=s))}", flush=True)
    mm = median_ms(lambda: torch.matmul(qs, x.T, out=s))
    tk = median_ms(lambda: torch.topk(s, k, dim=1))
    both = median_ms(lambda: torch.topk(torch.matmul(qs, x.T, out=s), k, dim=1))
    print(f"yardstick Q=256 N={N} d={d} k={k}: SGEMM alone {mm:.4f} ms, "
          f"torch.topk alone {tk:.4f} ms, both {both:.4f} ms "
          f"(TF32 {torch.backends.cuda.matmul.allow_tf32}) | {card}", flush=True)


if __name__ == "__main__":
    main()

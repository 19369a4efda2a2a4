"""Time probe variants of the score-matrix source on one GPU: the kernels
of a ``qscore.cu`` rebuilt with a few lines changed, launched directly
(no Python wrapper inside the clock) on B6, B8a, B7 and B8b at Q=512 and
Q=1.

    python scripts/qscore_probe.py <qscore.cu> <variant> [<variant> ...]

Variants of the tensor-core kernel (``qmip_mma_kernel``; a source that
still has the dp4a kernel ``qscore_l2_kernel`` runs B7 / B8b there, at its
own query tiles, and takes ``as_is`` only):
  as_is        the source unchanged
  nostore      copies and MMAs (and norms), the stores predicated off on
               the data
  nodots       copies and stores, the MMA loop removed (norms too)
  noreads      the corpus copies removed (MMAs on stale shared memory)
  stores_alone the corpus copies and the MMA loop removed
  nonorms      L2: the norms' dp4a sums removed (the norms stay 0; the
               shuffles and the combine kept)
  nocombine    L2: the dot stored in place of the combine, so the compiler
               drops the norms too: the L2 instance without what it adds
  kc64         64-byte int8 row chunks per stage (two stages a row at d=128)
  s2, s4       a ring of 2 / 4 stages
  bm256        256 corpus rows a tile at 64 and 128 queries (one warp
               column of 8 warps)

Table 1,000,000 x 128 random int8 codes (B8: int4 codes, packed), seed 5;
each time is the median of 20 calls by CUDA events around the launch
alone, after 3 warm calls.  Variants that keep the result are checked
against ``torch._int_mm`` (B7 / B8b: with the two norms and the combine
in int32); the output of the others is not meaningful.  Prints ``zero_``
of the [512, N] int32 output (the card's write rate) and ``_int_mm``
beside them.  Builds into build/qscore_probe/.
"""

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "qscore_probe"
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

NO_DOTS = ("for (int kk = 0; kk < C::KC / 32; ++kk) {",
           "for (int kk = 0; kk < 0; ++kk) {")
NO_READS = ("    stage_rows<C::BM, C::KC, C::SROW>(st, x, n0, N, width, k0, "
            "x_vec, tid);\n", "")
#: variant -> [(text in the source, replacement)]
VARIANTS = {
    "as_is": [],
    "nostore": [("        int32_t* o = out + q * N + n;\n",
                 "        if (val.x != 0x7fffffff) continue;\n"
                 "        int32_t* o = out + q * N + n;\n")],
    "nodots": [NO_DOTS],
    "noreads": [NO_READS],
    "stores_alone": [NO_READS, NO_DOTS],
    "nonorms": [("  s = __dp4a((int)w, (int)w, s);\n", "")],
    "nocombine": [("  return (int)(0u - (qq + xx - 2u * (uint32_t)dot));",
                   "  return dot;")],
    "kc64": [("static constexpr int KC = I4 ? 64 : 128;",
              "static constexpr int KC = 64;")],
    "s2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "s4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "bm256": [("static constexpr int WARPS_N = QT >= 64 ? 2 : 1;",
               "static constexpr int WARPS_N = QT >= 256 ? 2 : 1;")],
}
#: variants whose output is the score matrix
EXACT = ("as_is", "kc64", "s2", "s4", "bm256")


def build(source: str, names: list[str]) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_qscore.argtypes = [I, I, I, P, P, P, P, I, L, I, P]
        lib.rt_qscore.restype = I
        libs[name] = lib
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


def main():
    source = Path(sys.argv[1]).read_text()
    libs = build(source, sys.argv[2:])
    mma = "qscore_l2_kernel" not in source      # B7 / B8b on tensor cores
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    N, d = 1_000_000, 128
    def codes(lim, rows):
        return torch.randint(-lim, lim, (rows, d), generator=g,
                             device="cuda").to(torch.int8)

    x, x4 = codes(128, N), codes(8, N)
    px = ((x4[:, 0::2] + 8).to(torch.uint8)
          | ((x4[:, 1::2] + 8).to(torch.uint8) << 4)).contiguous()
    out = torch.empty((512, N), dtype=torch.int32, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def sq(v):
        return (v.int() ** 2).sum(1, dtype=torch.int32)

    cases = []
    for Q in (512, 1):
        q, q4 = codes(128, Q), codes(8, Q)
        pad = (0, 0, 0, max(0, 32 - Q))          # _int_mm needs > 16 rows
        tile = 128 if Q > 16 else 8
        dp4a_tile = 16 if Q > 16 else 1
        ip = torch._int_mm(torch.nn.functional.pad(q, pad), x.T)[:Q]
        ip4 = torch._int_mm(torch.nn.functional.pad(q4, pad), x4.T)[:Q]
        qe, qo = q4[:, 0::2].contiguous(), q4[:, 1::2].contiguous()
        cases += [
            (f"B6 Q={Q}", Q, tile, 0, 0, q, None, x, d, ip),
            (f"B8a Q={Q}", Q, tile, 1, 0, qe, qo, px, d // 2, ip4),
            (f"B7 Q={Q}", Q, tile if mma else dp4a_tile, 0, 1, q, None, x, d,
             -(sq(q)[:, None] + sq(x)[None, :] - 2 * ip)),
            (f"B8b Q={Q}", Q, tile if mma else dp4a_tile, 1, 1, qe, qo, px,
             d // 2, -(sq(q4)[:, None] + sq(x4)[None, :] - 2 * ip4))]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    for name, lib in libs.items():
        row = []
        for tag, Q, tile, i4, l2, a, b, xx, width, want in cases:
            o = out[:Q]

            def call():
                rc = lib.rt_qscore(i4, l2, tile, a.data_ptr(),
                                   None if b is None else b.data_ptr(),
                                   xx.data_ptr(), o.data_ptr(), Q, N, width,
                                   st)
                if rc:
                    raise SystemExit(f"{name} {tag}: CUDA error {rc}")

            ms = median_ms(call)
            ok = "" if name not in EXACT else (
                " =_int_mm" if torch.equal(o, want) else " DIFFERS")
            row.append(f"{tag} tile {tile}: {ms:.4f} ms{ok}")
        print(f"{sys.argv[1]} {name} | " + "; ".join(row), flush=True)
    print(f"zero_ [512, {N}] int32: {median_ms(out.zero_):.4f} ms; _int_mm "
          f"B6 Q=512: {median_ms(lambda: torch._int_mm(cases[0][5], x.T)):.4f}"
          f" ms | {card}", flush=True)


if __name__ == "__main__":
    main()

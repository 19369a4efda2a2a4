"""Time probe variants of the fused-scan sources (B2 fp32, B2 int8 with
``--int8``, B3 with ``--int4``, B4 with ``--adc``, B5 with ``--adc4``) on
one GPU: the kernels
of a ``fused_topk.cu`` (``adc.cu``) rebuilt with a few lines changed,
launched directly through ``rt_fused_topk`` (``rt_fused_adc``; no Python
wrapper inside the clock), beside the library yardstick split into its
parts.

    python scripts/scan_probe.py <fused_topk.cu> <variant> [<variant> ...]
    python scripts/scan_probe.py --int8 <fused_topk.cu> <variant> [...]
    python scripts/scan_probe.py --int4 <fused_topk.cu> <variant> [...]
    python scripts/scan_probe.py --adc [--random-only] <adc.cu> <variant> [...]
    python scripts/scan_probe.py --adc4 <adc.cu> <variant> [...]

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

With ``--int4``: variants of B3 (packed int4), as ``split_topk_kernel``
ran it (the first design) or as the int8 scan's int4 instances run it
where the source no longer has ``split_topk_kernel``; the same variant
names and markers as ``--int8`` (``sort_twice`` the new form only).
Corpus 4,000,000 x 256 random int4 codes packed two a byte (128 bytes a
row), queries in [-8, 8): Q=256 at k = 100 and 400, Q=1 at k=100, ip;
``as_is`` is checked bit for bit against the library's scores.  Then
the yardstick's parts: the unpack of the whole corpus to int8, ``_int_mm``
on the unpacked corpus alone, ``torch.topk`` alone, and the chunked
yardstick ``chip_smoke.library_topk`` runs (unpack, ``_int_mm`` and
``topk`` per 1M-row chunk).

With ``--adc4``: variants of B5 (4-bit ADC over packed codes) in an
``adc.cu``, as ``adc_split_kernel`` runs it (the gather design) or as the
one-hot MMA kernel does where the source has ``adc4_mma_kernel``:
  as_is        the source unchanged
  dots_only    the sums kept, the top-k upkeep predicated off on the data
  upkeep_only  the sums removed; each int score a hash of (query, row)
  pipe_only    the sums and the upkeep removed: the loads and barriers
  sort_twice   each list sorted once more after its compaction (the MMA
               kernel only)
  no_shl       a step without the one-hot build's clamped shift (the MMA
               kernel only)
  gbuf         the source unchanged, the lists in global memory (more
               blocks an SM; the MMA kernel only)
pq64x4 codes of 4,000,000 rows (32 packed bytes a row), random int8 LUTs
of 64 subspaces x 16 codewords, Q=256 at k = 100 and 400, Q=1 at k=100;
``as_is`` is checked bit for bit against the library's scores.  Then the
yardstick's parts: ``_int_mm`` of the [Q, 1024] LUT against the rows'
[N, 1024] int8 one-hot alone, ``torch.topk`` alone, and both.

With ``--adc``: variants of B4 (256-codeword ADC) in an ``adc.cu``, as
``adc_split_kernel`` runs it (the gather design, e.g. ``git show
134a9c5:src/repro_torch/csrc/adc.cu``) or as ``adc_word_kernel`` does
where the source has it:
  as_is        the source unchanged
  dots_only    the sums kept, the top-k upkeep predicated off on the data
  upkeep_only  the sums removed; each int score a hash of (query, row)
  pipe_only    the sums and the upkeep removed: the loads and barriers
  dots_g16     (the word kernel) the sums of G16, a lane's 16 queries in
               one 16-byte load and 8 split / add pairs a step (the
               kernel keeps G4 only; ``ADC8_G16`` puts G16 back), at 16
               queries and 8 warps a block, lists in global memory, the
               upkeep predicated off: against ``dots_only`` (G4)
  dots_alone, dots_alone_g16
               (the word kernel) the sums alone, G4 at its layout or G16
               at dots_g16's: the first 8 stages copied, then read again
               with no wait, the upkeep predicated off
  dots_alone_nolds
               the same without the LUT loads (each word made from its
               code): what the loads cost over the integer work
  dots_alone_4x4g, dots_alone_8x2g
               dots_alone at 4 queries and 4 warps a group or 8 and 2,
               lists in global memory: more resident warps an SM
  pipe_16x2    (the word kernel) the copies and waits alone at 16
               queries and 2 warps a query group
  pipe_nocopy  (the word kernel) the ring's waits and arrivals with no copy
  rows128      (the word kernel) 128-row tiles, four rows a lane, 4 stages
  tile16x2, tile4x4, tile8x4, tile8x4g, tile8x2g
               (the word kernel) the source unchanged at <queries a
               block>x<warps a query group>, "g": lists in global memory
pq32 codes of 4,000,000 rows (32 bytes a row), random int8 LUTs of 32
subspaces x 256 codewords, Q=256 at k = 100 and 400, Q=1 at k=100, ip;
``as_is`` is checked bit for bit against the plain version.  Then the
SIFT-like ``pq16+lpq`` request (1,000,000 x 128, l2, built by
``make_index``): its p50 through the Searcher at 256-query requests, its
LUT build, B4 through the public op, and each variant launched alone on
that request's LUT and codes (not with ``--random-only``).
"""

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
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
I8_NO_DOTS = ("for (int kk = 0; kk < KC / 32; ++kk) {",
              "for (int kk = 0; kk < 0; ++kk) {")
#: marker text as an older source has it
ALT = {I8_NO_DOTS[0]: "for (int kk = 0; kk < I8_KC / 32; ++kk) {"}
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


#: B5 as adc_split_kernel runs it (``--adc4`` on the gather design; the
#: markers are B4's too, which the probe does not time)
ADC_DOTS_ONLY = [
    ("        if (ok_row && q_base + qi < Q)\n          offer(",
     "        if (ok_row && q_base + qi < Q && acc[i][j] == 1234567)\n"
     "          offer("),
    ("      compact(buf, thresh, cnt, need, BQ, cap, k, cap - RL);\n"
     "    }\n  }\n\n  flush_partial",
     "    }\n  }\n\n  flush_partial")]
ADC_OLD = {
    "as_is": [],
    "dots_only": ADC_DOTS_ONLY,
    "upkeep_only": [
        ("for (int c0 = 0; c0 < W; c0 += DKC) {",
         "for (int c0 = 0; c0 < 0; c0 += DKC) {"),
        ("      for (int j = 0; j < TR; ++j) acc[i][j] = 0;",
         "      for (int j = 0; j < TR; ++j) acc[i][j] = " +
         HASH_I.format(row="t0 + lane + j * RL", q="q_base + qg * TQ + i")
         + ";")],
    "pipe_only": ADC_DOTS_ONLY + [("for (int w = 0; w < nw; ++w) {",
                                   "for (int w = 0; w < 0; ++w) {")],
}

#: B5 as adc4_mma_kernel runs it (the one-hot MMA design; the markers:
#: the code-byte loop of the sums, the accumulator reset, the vote)
ADC_NO_DOTS = ("for (int kb = 0; kb < nk; kb += 16) {",
               "for (int kb = 0; kb < 0; kb += 16) {")
ADC_NO_VOTE = (I8_VOTE, "if (!__any_sync(FULL, any && acc[0][0] == 1234567)) "
                        "continue;")
ADC_NEW = {
    "as_is": [],
    "dots_only": [ADC_NO_VOTE],
    "upkeep_only": [
        ADC_NO_DOTS,
        ("        for (int e = 0; e < 4; ++e) acc[mi][e] = 0;",
         "        for (int e = 0; e < 4; ++e) acc[mi][e] = " + HASH_I.format(
             row="t0 + mi * 16 + g + (e >> 1) * 8",
             q="q_base + warp * 8 + 2 * t4 + (e & 1)") + ";")],
    "pipe_only": [ADC_NO_DOTS, ADC_NO_VOTE],
    "sort_twice": [("      warp_compact(lists + (size_t)l * cap, n, thr, cap, k, lane);\n",
                    "      warp_compact(lists + (size_t)l * cap, n, thr, cap, k, lane);\n"
                    "      warp_sort_desc(lists + (size_t)l * cap, cap, lane);\n")],
    # a step without the one-hot's clamped shift
    "no_shl": [('  asm("shl.b32 %0, %1, %2;\\n" : "=r"(r) : "r"(1u), "r"(sh));',
                "  r = sh;")],
    # the source unchanged, the lists in global memory (more blocks an SM)
    "gbuf": [],
}

#: B4 as adc_word_kernel runs it (markers: the loop of a chunk's sums, the
#: score reset of a tile, the vote)
ADC8_NO_DOTS = [("      load(0, xa);\n", ""),
                ("for (int J = 0; J < 8; J += 2) {",
                 "for (int J = 0; J < 0; J += 2) {")]
ADC8_NO_VOTE = ("if (!__any_sync(FULL, any))  // no row of the tile passes",
                "if (!__any_sync(FULL, any && sc[0][0] == 1234567))")
#: the dots alone: the first W_STAGES steps copied, then read again
ADC8_ALONE = [ADC8_NO_VOTE,
              ("for (long long i = 0; i < my_tiles; ++i)",
               "for (long long i = 0; i < (my_tiles < W_STAGES ? my_tiles "
               ": W_STAGES); ++i)"),
              ("      mbar_wait(&full[slot], (unsigned)((st / W_STAGES) & 1));",
               "      if (st < W_STAGES) mbar_wait(&full[slot], 0u);")]
#: G16, which the kernel dropped: a lane's 16 queries (four words, W_V = 4)
#: in one 16-byte load a step and 8 split / add pairs; the word kernel's
#: code as it was timed, with a query group of 16 queries
ADC8_G16 = [
    ("constexpr int W_CHUNK_WORDS = 256 * 32;",
     "constexpr int W_V = 4;\nconstexpr int W_CHUNK_WORDS = 256 * 32 * W_V;"),
    ("(size_t)warps * 4 * cap * 8);", "(size_t)warps * 4 * W_V * cap * 8);"),
    ("template <bool GBUF, bool LUTG>\n__global__",
     "template <int V, bool GBUF, bool LUTG>\n__global__"),
    ("  constexpr int G = 4;\n", "  constexpr int G = 4 * V;\n"),
    ("lw + (LUTG ? 0 : (size_t)ng * nch * W_CHUNK_WORDS));",
     "lw + (LUTG ? 0 : (size_t)ng * nch * 256 * 32 * V));"),
    ("""    for (int e = warp; e < ng * nch * 64; e += nwarps) {
      const int c4 = e & 63, r = e >> 6;
      const int ch = r % nch, g = r / nch;
      const int sub = ch * W_CW + lane;
      const int q0 = q_block + g * G;""",
     """    for (int e = warp; e < ng * nch * V * 64; e += nwarps) {
      const int c4 = e & 63;
      int r = e >> 6;
      const int v = r % V;
      r /= V;
      const int ch = r % nch, g = r / nch;
      const int sub = ch * W_CW + lane;
      const int q0 = q_block + g * G + 4 * v;"""),
    ("""      uint32_t* dst =
          lw + ((size_t)(g * nch + ch) * 256 + 4 * c4) * 32 + lane;
      dst[0] = __byte_perm(t0, t1, 0x5410);
      dst[32] = __byte_perm(t0, t1, 0x7632);
      dst[64] = __byte_perm(t2, t3, 0x5410);
      dst[96] = __byte_perm(t2, t3, 0x7632);""",
     """      uint32_t* dst = lw + ((size_t)(g * nch + ch) * 256 + 4 * c4) * 32 * V +
                      lane * V + v;
      dst[0] = __byte_perm(t0, t1, 0x5410);
      dst[32 * V] = __byte_perm(t0, t1, 0x7632);
      dst[64 * V] = __byte_perm(t2, t3, 0x5410);
      dst[96 * V] = __byte_perm(t2, t3, 0x7632);"""),
    ("smem_addr(lw + (size_t)grp * nch * W_CHUNK_WORDS);",
     "smem_addr(lw + (size_t)grp * nch * 256 * 32 * V);"),
    ("xo[j] = lg + 4 * (lane ^ j);", "xo[j] = lg + 4 * V * (lane ^ j);"),
    ("""    uint32_t E[WR], O[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) E[r] = O[r] = 0u;""",
     """    uint32_t E[WR][V], O[WR][V];
#pragma unroll
    for (int r = 0; r < WR; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) E[r][v] = O[r][v] = 0u;"""),
    ("auto load = [&](int J, uint32_t (&x)[4][WR]) {",
     "auto load = [&](int J, uint32_t (&x)[4][WR][V]) {"),
    ("              x[t][r] = lut_word_g(lut, qg0, Q, mb, ch * W_CW + s, c);",
     """#pragma unroll
              for (int v = 0; v < V; ++v)
                x[t][r][v] =
                    lut_word_g(lut, qg0 + 4 * v, Q, mb, ch * W_CW + s, c);"""),
    ("""              const uint32_t a = cc * 128 + xo[4 * J + t];
              asm("ld.shared.u32 %0, [%1];" : "=r"(x[t][r]) : "r"(a));""",
     """              const uint32_t a = cc * (128 * V) + xo[4 * J + t];
              if constexpr (V == 4) {
                asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                    : "=r"(x[t][r][0]), "=r"(x[t][r][1]), "=r"(x[t][r][2]),
                      "=r"(x[t][r][3]) : "r"(a));
              } else {
                asm("ld.shared.u32 %0, [%1];" : "=r"(x[t][r][0]) : "r"(a));
              }"""),
    ("""      auto add = [&](const uint32_t (&x)[4][WR]) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int r = 0; r < WR; ++r) {
            const uint32_t e = x[t][r] & 0x00ff00ffu;
            const uint32_t o = __byte_perm(x[t][r], 0u, 0x4341);
            asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(E[r]) : "r"(e), "r"(one));
            asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(O[r]) : "r"(o), "r"(one));
          }
      };
      uint32_t xa[4][WR], xb[4][WR];""",
     """      auto add = [&](const uint32_t (&x)[4][WR][V]) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int r = 0; r < WR; ++r)
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const uint32_t e = x[t][r][v] & 0x00ff00ffu;
              const uint32_t o = __byte_perm(x[t][r][v], 0u, 0x4341);
              asm("mad.lo.u32 %0, %1, %2, %0;"
                  : "+r"(E[r][v]) : "r"(e), "r"(one));
              asm("mad.lo.u32 %0, %1, %2, %0;"
                  : "+r"(O[r][v]) : "r"(o), "r"(one));
            }
      };
      uint32_t xa[4][WR][V], xb[4][WR][V];"""),
    ("""        for (int r = 0; r < WR; ++r) {
          sc[r][0] += (int)(E[r] & 0xffffu);
          sc[r][1] += (int)(O[r] & 0xffffu);
          sc[r][2] += (int)(E[r] >> 16);
          sc[r][3] += (int)(O[r] >> 16);
          E[r] = O[r] = 0u;
        }""",
     """        for (int r = 0; r < WR; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            sc[r][4 * v] += (int)(E[r][v] & 0xffffu);
            sc[r][4 * v + 1] += (int)(O[r][v] & 0xffffu);
            sc[r][4 * v + 2] += (int)(E[r][v] >> 16);
            sc[r][4 * v + 3] += (int)(O[r][v] >> 16);
            E[r][v] = O[r][v] = 0u;
          }"""),
    ("auto fn = adc_word_kernel<GBUF, LUTG>;",
     "auto fn = adc_word_kernel<W_V, GBUF, LUTG>;"),
    ("  const int bq = ng * 4;\n", "  const int bq = ng * 4 * W_V;\n"),
    ("""  if (bq <= 0 || bq % 4 != 0 || subsets <= 0) return -1;
  return w_blocks(bq / 4, subsets, cap, gbuf != 0, lutg != 0, mb);""",
     """  if (bq <= 0 || bq % (4 * W_V) != 0 || subsets <= 0) return -1;
  return w_blocks(bq / (4 * W_V), subsets, cap, gbuf != 0, lutg != 0, mb);"""),
    ("(word && (bq % 4 != 0 || subsets <= 0 || bq / 4 * subsets > W_MAXWARPS ||",
     "(word && (bq % (4 * W_V) != 0 || subsets <= 0 ||\n"
     "                bq / (4 * W_V) * subsets > W_MAXWARPS ||"),
    ("err = launch_word_any(bq / 4, subsets,",
     "err = launch_word_any(bq / (4 * W_V), subsets,"),
]
ADC8_NEW = {
    "as_is": [],
    "dots_only": [ADC8_NO_VOTE],
    "upkeep_only": ADC8_NO_DOTS + [
        ("      for (int q = 0; q < G; ++q) sc[r][q] = 0;",
         "      for (int q = 0; q < G; ++q) sc[r][q] = " + HASH_I.format(
             row="t0 + 32 * r + lane", q="qg0 + q") + ";")],
    "pipe_only": ADC8_NO_DOTS + [ADC8_NO_VOTE],
    # the dots of G16: a lane's 16 queries in one 16-byte load a step
    "dots_g16": [ADC8_NO_VOTE] + ADC8_G16,
    # the dots alone (no copies past the first stages, no upkeep), G4 / G16
    "dots_alone": ADC8_ALONE,
    "dots_alone_g16": ADC8_ALONE + ADC8_G16,
    # the dots alone without their LUT loads (a word made from the code)
    "dots_alone_nolds": ADC8_ALONE + [(
        '              asm("ld.shared.u32 %0, [%1];" : "=r"(x[t][r]) : "r"(a));',
        "              x[t][r] = cc * 0x01010101u;")],
    # the dots alone at more warps an SM (lists in global memory)
    "dots_alone_4x4g": ADC8_ALONE,
    "dots_alone_8x2g": ADC8_ALONE,
    # the copies and waits alone at 16 queries and 2 warps a query group
    "pipe_16x2": ADC8_NO_DOTS + [ADC8_NO_VOTE],
    # 128-row tiles (four rows a lane) in a ring of 4 stages
    "rows128": [("constexpr int W_BM = 64;", "constexpr int W_BM = 128;"),
                ("constexpr int W_STAGES = 8;", "constexpr int W_STAGES = 4;")],
    # the copies and waits with no copy: the ring's protocol alone
    "pipe_nocopy": ADC8_NO_DOTS + [ADC8_NO_VOTE, (
        "        i8_stage<W_BM, 32, W_CW>(smem + slot * W_STAGE, W_CW, cb, row_of(i),\n"
        "                                 N, mb, ch * W_CW, c_mode, lane);\n", "")],
    # the source unchanged at other query tiles and list placements
    "tile16x2": [],
    "tile4x4": [],
    "tile8x4": [],
    "tile8x4g": [],
    "tile8x2g": [],
}
#: (queries a block, warps a query group, lists in global memory) of the
#: variants launched at a layout of their own
ADC8_TILES = {"dots_g16": (16, 8, True), "dots_alone_g16": (16, 8, True),
              "dots_alone_4x4g": (4, 4, True), "dots_alone_8x2g": (8, 2, True),
              "tile16x2": (16, 2, False),
              "tile4x4": (4, 4, False), "tile8x4": (8, 4, False),
              "pipe_16x2": (16, 2, False),
              "tile8x4g": (8, 4, True), "tile8x2g": (8, 2, True)}

#: (entry point, table of the newer design, of the older, marker of the newer)
MODES = {
    "fp32": ("rt_fused_topk", NEW, OLD, "f32_topk_kernel"),
    "int8": ("rt_fused_topk", I8_NEW, I8_OLD, "i8_topk_kernel"),
    "int4": ("rt_fused_topk", I8_NEW, I8_OLD, "bool I4 = false>"),
    "adc4": ("rt_fused_adc", ADC_NEW, ADC_OLD, "adc4_mma_kernel"),
    "adc": ("rt_fused_adc", ADC8_NEW, ADC_OLD, "adc_word_kernel"),
}


def build(path: Path, names: list[str], mode: str = "fp32"):
    source = path.read_text()
    entry, new_table, old_table, marker = MODES[mode]
    new = marker in source
    table = new_table if new else old_table
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(path.parent / "topk_common.cuh", OUT / "topk_common.cuh")
    procs = {}
    for name in names:
        text = source
        for old, rep in table[name]:
            if old not in text:
                old = ALT.get(old, old)
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, rep)
        tag = f"{mode}_" + ("new" if new else "old")
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
        fn = getattr(lib, entry)
        n_args = len(re.search(entry + r"\(([^)]*)\)", source)
                     .group(1).split(","))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if n_args == 17:       # kind, l2, bq, cap, q0, q1, x, mask, part, ...
            fn.argtypes = [I, I, I, I, P, P, P, P, P, P, P, I, L, I, I, I, P]
        elif n_args == 20:     # kbits, bq, mode, subsets, cap, ...
            fn.argtypes = [I, I, I, I, I, P, P, P, P, P, P, P, P, P,
                           I, L, I, I, I, P]
        else:                  # ... part, gbuf, mbuf, out_s, out_i, ...
            fn.argtypes = [I, I, I, I, P, P, P, P, P, P, P, P, P,
                           I, L, I, I, I, P]
        fn.restype = I
        if hasattr(lib, "rt_adc_word_blocks_per_sm"):
            fn.occupancy = lib.rt_adc_word_blocks_per_sm
            fn.occupancy.argtypes = [I] * 6
            fn.occupancy.restype = I
        if hasattr(lib, "rt_i8_blocks_per_sm"):
            fn.occupancy = lib.rt_i8_blocks_per_sm
            fn.occupancy.argtypes = [I, I, I, I, I] + (
                [I] if "int i4)" in source else [])
            fn.occupancy.restype = I
        fn.n_args = n_args
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


def first_layout(Q: int, N: int, k: int):
    """(queries a block, buffer keys, splits) of the first int design
    (``split_topk_kernel``): 16 queries a block while the buffer of
    next_pow2(2k + 64) keys is at most 512, 8 to 1024, 4 for batches of at
    most 4; 528 blocks; shared-memory buffers (k <= 480 here)."""
    cap = _pow2(2 * k + 64)
    assert cap <= 1024, "the first design's layout here: k <= 480"
    bq = 4 if Q <= 4 else 16 if cap <= 512 else 8
    splits = max(1, min(-(-528 // -(-Q // bq)), -(-N // max(2048, 2 * k)),
                        65535))
    return bq, cap, splits


def i8_launcher(fn, new: bool, q, x, k, splits=None):
    """A closure launching B2 int8 ip with the layout its source expects:
    ``layout`` for ``i8_topk_kernel``, else the first design's
    (``first_layout``)."""
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
        occ = fn.occupancy(0, bq, cap, int(gkeys > 0), x.shape[1],
                           *([0] if len(fn.occupancy.argtypes) == 6 else []))
        print(f"  Q={Q} k={k}: {bq} queries a block, {splits} splits, "
              f"{occ} blocks an SM by the occupancy API (layout: "
              f"{F.i8_blocks_per_sm(bq, cap, gkeys > 0, x.shape[1])})",
              flush=True)
    else:
        (bq, cap, splits), gkeys = first_layout(Q, N, k), 0
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
    libs = build(Path(path), names, "int8")
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


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def _pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def i4_launcher(fn, new: bool, qe, qo, x, k):
    """A closure launching B3 ip: ``layout(KIND_I4, ...)`` for the int8
    scan's int4 instances, else the first design's (``first_layout``)."""
    from repro_torch.kernels import fused_topk as F

    Q, N, w = qe.shape[0], x.shape[0], x.shape[1]
    dev = x.device
    st = torch.cuda.current_stream().cuda_stream
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if new:
        lay = F.layout(F.KIND_I4, Q, N, k, w)
        bq, cap, splits, gkeys = lay.bq, lay.cap, lay.splits, lay.gbuf_keys
    else:
        (bq, cap, splits), gkeys = first_layout(Q, N, k), 0
    print(f"  Q={Q} k={k}: {bq} queries a block, {splits} splits, cap {cap}"
          f"{', global lists' if gkeys else ''}", flush=True)
    part = torch.empty(Q * splits * k, dtype=torch.int64, device=dev)
    gbuf = torch.empty(gkeys, dtype=torch.int64, device=dev) if gkeys else None

    def call():
        rc = fn(2, 0, bq, cap, qe.data_ptr(), qo.data_ptr(), x.data_ptr(),
                None, part.data_ptr(),
                None if gbuf is None else gbuf.data_ptr(), None,
                out_s.data_ptr(), out_i.data_ptr(), Q, N, w, k, splits, st)
        if rc:
            raise SystemExit(f"CUDA error {rc}")
    return call, out_s


def main_int4(path: str, names: list[str]):
    from repro_torch.core import pack as PK

    libs = build(Path(path), names, "int4")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    N, d = 4_000_000, 256
    x8 = torch.randint(-8, 8, (N, d), generator=g, device="cuda",
                       dtype=torch.int8)
    q = torch.randint(-8, 8, (256, d), generator=g, device="cuda",
                      dtype=torch.int8)
    x = PK.pack_int4(x8)
    qe, qo = q[:, 0::2].contiguous(), q[:, 1::2].contiguous()
    card = card_name()
    shapes = ((256, 100), (256, 400), (1, 100))
    want = {}
    for Q, k in shapes:
        qq = q[:Q] if Q >= 17 else q[:Q].repeat(17, 1)[:17]   # _int_mm: M > 16
        want[Q, k] = torch.topk(torch._int_mm(qq, x8.T)[:Q], k,
                                dim=1).values.float()
    for name, (fn, _, new) in libs.items():
        row = []
        for Q, k in shapes:
            call, out_s = i4_launcher(fn, new, qe[:Q].contiguous(),
                                      qo[:Q].contiguous(), x, k)
            ms = median_ms(call)
            tag = ""
            if name == "as_is":
                tag = (" =library" if torch.equal(out_s, want[Q, k])
                       else " DIFFERS")
            row.append(f"Q={Q} k={k}: {ms:.4f} ms{tag}")
        print(f"{path} int4 {name} | " + "; ".join(row) + f" | {card}",
              flush=True)
    if "as_is" in libs:
        call, _ = i4_launcher(libs["as_is"][0], libs["as_is"][2], qe, qo, x,
                              100)
        print(f"as_is Q=256 k=100 under load: {clocks(call)}", flush=True)
    rd = median_ms(lambda: torch.amax(x.view(torch.int32)))
    print(f"read-only reference: torch.amax over the {x.numel()} packed bytes "
          f"{rd:.4f} ms (bound {x.numel() / 3.35e9:.4f} ms) | {card}",
          flush=True)
    up = median_ms(lambda: PK.unpack_int4(x))
    s = torch._int_mm(q, x8.T)
    mm = median_ms(lambda: torch._int_mm(q, x8.T))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import library_topk

    for k in (100, 400):
        tk = median_ms(lambda: torch.topk(s, k, dim=1))
        lib = median_ms(lambda: library_topk(q, x, k, packed=True), n=5)
        print(f"yardstick int4 Q=256 N={N} d={d} k={k}: unpack alone "
              f"{up:.4f} ms, _int_mm (unpacked) alone {mm:.4f} ms, torch.topk "
              f"alone {tk:.4f} ms, library_topk (chunked: unpack, _int_mm, "
              f"topk) {lib:.4f} ms | {card}", flush=True)


def adc4_launcher(fn, new: bool, le, lo, codes, k, force_gbuf=False):
    """A closure launching B5: ``adc_layout`` for the one-hot MMA kernel,
    else the gather design's layout for these shapes (16 queries a block,
    4 for batches of at most 4; buffers of next_pow2(2k + 64) keys in
    shared memory; 528 blocks)."""
    from repro_torch.kernels import adc as A

    Q, N, mb = le.shape[0], codes.shape[0], codes.shape[1]
    dev = codes.device
    st = torch.cuda.current_stream().cuda_stream
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if new:
        lay = A.adc_layout(k, mb, 4, Q, N)
        bq, lutg, cap, splits, gkeys = (lay.bq, lay.mode, lay.cap,
                                        lay.splits, lay.gbuf_keys)
        if force_gbuf and not lay.gather:
            per_sm = A.a4_blocks_per_sm(bq, cap, True, mb)
            splits = max(1, min(per_sm * 132 // -(-Q // bq),
                                -(-N // max(2048, 2 * k))))
            gkeys = -(-Q // bq) * splits * bq * cap
    else:
        bq = 4 if Q <= 4 else 16
        cap, lutg, gkeys = _pow2(2 * k + 64), 0, 0
        splits = max(1, min(-(-528 // -(-Q // bq)),
                            -(-N // max(2048, 2 * k)), 65535))
        # (pq64x4: LUTs of 1 KB, so 16 queries a block at any k here)
    print(f"  Q={Q} k={k}: {bq} queries a block, {splits} splits, cap {cap}"
          f"{', global lists' if gkeys else ''}", flush=True)
    part = torch.empty(Q * splits * k, dtype=torch.int64, device=dev)
    gbuf = torch.empty(gkeys, dtype=torch.int64, device=dev) if gkeys else None

    def call():
        rc = adc_call(fn, 4, bq, lutg, 1, cap, le, lo, codes, part, gbuf,
                      out_s, out_i, k, splits)
        if rc:
            raise SystemExit(f"CUDA error {rc}")
    return call, out_s


def adc_call(fn, kbits, bq, mode, subsets, cap, lut0, lut1, codes, part,
             gbuf, out_s, out_i, k, splits):
    """One ``rt_fused_adc`` launch through either entry: the parent's (19
    arguments) or the one with the word kernel's warps a query group
    (20)."""
    ptr = lambda t: None if t is None else t.data_ptr()
    st = torch.cuda.current_stream().cuda_stream
    head = (kbits, bq, mode) + ((subsets,) if fn.n_args == 20 else ()) + (cap,)
    mid = (ptr(lut0), ptr(lut1), codes.data_ptr(), None, part.data_ptr(),
           ptr(gbuf), None)
    return fn(*head, *mid, out_s.data_ptr(), out_i.data_ptr(),
              lut0.shape[0], codes.shape[0], codes.shape[1], k, splits, st)


def main_adc4(path: str, names: list[str]):
    from repro_torch.core import pack as PK

    libs = build(Path(path), names, "adc4")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    N, M, Qm = 4_000_000, 64, 256
    lut = torch.randint(-128, 128, (Qm, M, 16), generator=g,
                        device="cuda").to(torch.int8)
    codes = torch.randint(0, 16, (N, M), generator=g,
                          device="cuda").to(torch.uint8)
    packed = PK.pack_uint4(codes)
    le = lut[:, 0::2].reshape(Qm, -1).contiguous()
    lo = lut[:, 1::2].reshape(Qm, -1).contiguous()
    onehot = torch.zeros((N, M * 16), dtype=torch.int8, device="cuda")
    for s0 in range(0, N, 1 << 20):
        oh = onehot[s0:s0 + (1 << 20)].view(-1, M, 16)
        oh.scatter_(2, codes[s0:s0 + (1 << 20)].long().unsqueeze(-1), 1)
    del codes
    lut2d = lut.reshape(Qm, -1).contiguous()
    card = card_name()
    shapes = ((256, 100), (256, 400), (1, 100))
    want = {}
    for Q, k in shapes:
        qq = lut2d[:Q] if Q >= 17 else lut2d[:Q].repeat(17, 1)[:17]
        want[Q, k] = torch.topk(torch._int_mm(qq, onehot.T)[:Q], k,
                                dim=1).values.float()
    for name, (fn, _, new) in libs.items():
        row = []
        for Q, k in shapes:
            call, out_s = adc4_launcher(fn, new, le[:Q].contiguous(),
                                        lo[:Q].contiguous(), packed, k,
                                        force_gbuf=name == "gbuf")
            ms = median_ms(call)
            tag = ""
            if name == "as_is":
                tag = (" =library" if torch.equal(out_s, want[Q, k])
                       else " DIFFERS")
            row.append(f"Q={Q} k={k}: {ms:.4f} ms{tag}")
        print(f"{path} adc4 {name} | " + "; ".join(row) + f" | {card}",
              flush=True)
    if "as_is" in libs:
        call, _ = adc4_launcher(libs["as_is"][0], libs["as_is"][2], le, lo,
                                packed, 100)
        print(f"as_is Q=256 k=100 under load: {clocks(call)}", flush=True)
    s = torch._int_mm(lut2d, onehot.T)
    mm = median_ms(lambda: torch._int_mm(lut2d, onehot.T))
    for k in (100, 400):
        tk = median_ms(lambda: torch.topk(s, k, dim=1))
        both = median_ms(lambda: torch.topk(torch._int_mm(lut2d, onehot.T), k,
                                            dim=1), n=5)
        print(f"yardstick adc4 Q=256 N={N} M={M} k={k}: _int_mm (one-hot) "
              f"alone {mm:.4f} ms, torch.topk alone {tk:.4f} ms, both "
              f"{both:.4f} ms | {card}", flush=True)


def b4_parent_layout(Q: int, N: int, k: int, mb: int):
    """(queries a block, buffer keys, splits) of the parent's B4 gather
    layout (``adc_split_kernel``, LUTs and buffers in shared memory): the
    widest of 16, 8, 4, 2, 1 queries (4, 2, 1 for batches of at most 4)
    whose LUTs, buffers of next_pow2(2k + 256 / min(bq, 4)) keys and code
    tile fit in 227 KB; 528 blocks."""
    for bq in (4, 2, 1) if Q <= 4 else (16, 8, 4, 2, 1):
        cap = _pow2(2 * k + 256 // min(bq, 4))
        smem = (bq * cap * 8 + bq * 8 + -(-mb // 4) * 4 * bq * 256
                + 256 // min(bq, 4) * 4 * 9 * 4 + bq * 8)
        if smem <= 232448:
            break
    splits = max(1, min(-(-528 // -(-Q // bq)), -(-N // max(2048, 2 * k)),
                        65535))
    return bq, cap, splits


def adc8_launcher(fn, new: bool, lut2d, codes, k, tile=None):
    """A closure launching B4 with the layout its source expects:
    ``adc_layout`` where the source has the word kernel (or, for the word
    kernel at Q >= 5, ``tile``'s queries a block, warps a query group and
    list placement, one wave of blocks by the occupancy API), else the
    parent's (``b4_parent_layout``)."""
    from repro_torch.kernels import adc as A

    Q, N, mb = lut2d.shape[0], codes.shape[0], codes.shape[1]
    dev = codes.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    gbuf = None
    if new:
        lay = A.adc_layout(k, mb, 8, Q, N)
        if tile is not None and lay.word:
            bq, t, gb = tile
            gb = gb or A.w_smem_bytes(bq, t, lay.cap, mb, False,
                                      lay.lutg) > A.SMEM_MAX
            per_sm = fn.occupancy(bq, t, lay.cap, int(gb), int(lay.lutg), mb)
            splits = max(1, min(per_sm * 132 // -(-Q // bq),
                                -(-N // max(2048, 2 * k))))
            lay = lay._replace(bq=bq, subsets=t, splits=splits, gbuf_keys=(
                -(-Q // bq) * splits * bq * t * lay.cap if gb else 0))
        bq, mode, subsets, cap, splits = (lay.bq, lay.mode, lay.subsets,
                                          lay.cap, lay.splits)
        parts = lay.parts
        if lay.gbuf_keys:
            gbuf = torch.empty(lay.gbuf_keys, dtype=torch.int64, device=dev)
        if lay.word:
            occ = fn.occupancy(bq, subsets, cap, int(gbuf is not None),
                               int(lay.lutg), mb)
            print(f"  Q={Q} k={k}: {occ} blocks an SM by the occupancy API",
                  flush=True)
    else:
        (bq, cap, splits), mode, subsets = b4_parent_layout(Q, N, k, mb), 0, 1
        parts = splits
    print(f"  Q={Q} k={k}: {bq} queries a block, {subsets} warps a query "
          f"group, {splits} splits, cap {cap}, mode {mode}"
          f"{', global lists' if gbuf is not None else ''}", flush=True)
    part = torch.empty(Q * parts * k, dtype=torch.int64, device=dev)

    def call():
        rc = adc_call(fn, 8, bq, mode, subsets, cap, lut2d, None, codes,
                      part, gbuf, out_s, out_i, k, splits)
        if rc:
            raise SystemExit(f"CUDA error {rc}")
    return call, out_s, out_i


def main_adc(path: str, names: list[str], sift: bool = True):
    from repro_torch.data import synthetic
    from repro_torch.engine.scorer import _prepare_pq_lut
    from repro_torch.kernels import adc as A
    from repro_torch.kernels import ops as K
    from repro_torch.knn import make_index

    libs = build(Path(path), names, "adc")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    N, M, Qm = 4_000_000, 32, 256
    lut = torch.randint(-128, 128, (Qm, M, 256), generator=g,
                        device="cuda").to(torch.int8)
    codes = torch.randint(0, 256, (N, M), generator=g,
                          device="cuda").to(torch.uint8)
    lut2d = lut.reshape(Qm, -1).contiguous()
    card = card_name()
    shapes = ((256, 100), (256, 400), (1, 100))
    want = {}
    for Q, k in shapes:
        want[Q, k] = A.fused_adc_plain(lut2d[:Q], codes, k=k, n_codewords=256)
    for name, (fn, _, new) in libs.items():
        row = []
        for Q, k in shapes:
            call, out_s, out_i = adc8_launcher(fn, new, lut2d[:Q].contiguous(),
                                               codes, k, ADC8_TILES.get(name))
            ms = median_ms(call)
            tag = ""
            if name == "as_is":
                ok = (torch.equal(out_s, want[Q, k][0])
                      and torch.equal(out_i, want[Q, k][1]))
                tag = " =plain" if ok else " DIFFERS"
            row.append(f"Q={Q} k={k}: {ms:.4f} ms{tag}")
        print(f"{path} adc {name} | " + "; ".join(row) + f" | {card}",
              flush=True)
    if "as_is" in libs:
        call, _, _ = adc8_launcher(libs["as_is"][0], libs["as_is"][2], lut2d,
                                   codes, 100)
        print(f"as_is Q=256 k=100 under load: {clocks(call)}", flush=True)
    del lut, codes, lut2d, want
    torch.cuda.empty_cache()
    if not sift:
        return

    # the SIFT-like pq16+lpq request: p50, LUT build, B4, and the variants
    corpus, queries, metric = synthetic.load("sift", 1_000_000, 1000)
    idx = make_index("pq16+lpq", corpus, metric=metric)
    srch = idx.searcher(100, batch_sizes=(1, 8, 32, 256))
    for b in (1, 8, 32, 256):
        srch(queries[:b])
    torch.cuda.synchronize()
    lat = []
    for s0 in range(0, 1000, 256):
        t = time.perf_counter()
        srch(queries[s0:s0 + 256])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    q = queries[:256]
    store = idx.store
    lut = _prepare_pq_lut(q, store, metric)
    lut_ms = median_ms(lambda: _prepare_pq_lut(q, store, metric))
    b4_ms = median_ms(lambda: K.fused_adc_topk(lut, store.codes, 100))
    print(f"sift pq16+lpq 1000000x128 l2: request p50 "
          f"{statistics.median(lat):.4f} ms (256-query requests, "
          f"{len(lat)} requests); LUT build {lut_ms:.4f} ms; B4 (public op) "
          f"{b4_ms:.4f} ms; LUT values in [{int(lut.min())}, "
          f"{int(lut.max())}] | {card}", flush=True)
    lut2d = lut.reshape(lut.shape[0], -1).contiguous()
    for name, (fn, _, new) in libs.items():
        call, _, _ = adc8_launcher(fn, new, lut2d, store.codes, 100,
                                   ADC8_TILES.get(name))
        print(f"sift pq16 adc {name} Q=256 k=100: {median_ms(call):.4f} ms "
              f"| {card}", flush=True)


def main():
    if sys.argv[1] == "--adc":
        if sys.argv[2] == "--random-only":
            return main_adc(sys.argv[3], sys.argv[4:], sift=False)
        return main_adc(sys.argv[2], sys.argv[3:])
    if sys.argv[1] == "--int8":
        return main_int8(sys.argv[2], sys.argv[3:])
    if sys.argv[1] == "--int4":
        return main_int4(sys.argv[2], sys.argv[3:])
    if sys.argv[1] == "--adc4":
        return main_adc4(sys.argv[2], sys.argv[3:])
    libs = build(Path(sys.argv[1]), sys.argv[2:], "fp32")
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

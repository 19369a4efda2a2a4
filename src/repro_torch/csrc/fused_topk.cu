// B2 and B3: fused corpus scan + running top-k.
//
// Replaces the TPU kernels repro/kernels/fused_topk.py `fused_topk_pallas`
// (B2: int8 or f32 codes, ip or l2; `_make_kernel`, `_merge_tile`,
// `_ip_tile`, `_l2_tile`) and `fused_topk4_pallas` (B3: packed int4 codes,
// tiles from repro/kernels/packed.py `qmip4_tile` / `ql24_tile`,
// `unpack_nibbles`).  What carries over is what they compute: every corpus
// row scored against every query, the best k per query kept, pad and
// masked rows never returned, the [Q, N] score matrix never written to
// device memory.  The TPU grid walks corpus tiles in order with the
// [bq, k] best set in VMEM; that gives 8 blocks at Q=1000 and cannot fill
// 132 SMs, so every kernel here splits the corpus: pass 1 is grid
// (ceil(Q / BQ), S), block (qb, s) scoring BQ queries against the s-th
// contiguous range of corpus rows (B2 fp32; block x is the query block, so
// the blocks that read one range are resident together and share it
// through L2; the int scans, B2 int8 and B3, stride their 32-row tiles
// over the splits instead) and
// writing each query's best k of it to a [Q, S, k] scratch; pass 2
// (topk_common.cuh `merge_topk_kernel`) merges the S lists of each query
// and writes ([Q, k] f32, [Q, k] i32).  The Python wrapper
// (kernels/fused_topk.py `layout`) is the one place that chooses BQ, S,
// the candidate capacity and where the candidates live.
//
// B2 fp32 (`f32_topk_kernel`).  Bound on the H100 by operations: 2*Q*N*d
// FLOP at 67 TFLOP/s on the CUDA cores (7.8 ms at Q=256 over 4M x 256),
// since the contract is fp32 (no TF32, no tensor cores); a single request
// is bound by the N*d*4 bytes.  The design against that bound:
//   - a register tile of 4 queries x 8 rows a thread at 32 queries a block
//     (1 x 8 at 8, 1 x 1 at one query, the warps then split the rows), so
//     each 16-byte shared load feeds 8-32 FFMA, within 128 registers so
//     that two blocks share an SM: at one block an SM (8 x 8 at 64
//     queries, 252 registers) the FFMA pipes idled; each accumulator is
//     one fmaf chain over d in dimension order (the order ROADMAP C6
//     measures);
//   - a 2-stage cp.async ring (16 floats a row, or 32 where the copies
//     bound the tile), rows landing row-major with a 4-float pad so
//     16-byte reads of 8 consecutive rows are conflict-free; 16-byte copies
//     for aligned rows with d % 4 == 0, 4-byte copies otherwise; ragged Q,
//     N and d zero-filled in shared memory only;
//   - candidates kept per warp: each warp owns one list per query it
//     scores (and per row group at one query a block), appends a tile's
//     survivors with one ballot per 32 rows, and sorts a list down to k
//     (warp_compact) only when the next 32 could overflow it, so the
//     upkeep takes no block barrier (the parent's four `compact` barriers
//     a tile also stalled its dot loop); the lists live in shared memory
//     (two blocks an SM while k <= 160), or in a global scratch for k past
//     about 2000.
//   What still holds it back (PERF.md): its dot loop, at about 0.42 of
//   the FFMA peak.
//
// B2 int8 (`i8_topk_kernel`).  Bound on the H100 by the N*d code bytes
// (0.306 ms over 4M x 256 at any batch: 2*Q*N*d operations need 0.27 ms at
// Q=256 on the int8 tensor cores).  The first design (split_topk_kernel,
// B3's too until its own redesign) spent its time on dp4a dots,
// synchronous staging and a block-wide sort of every query's buffer after
// each 64-row insert round (PERF.md).  The design against that:
//   - dots on the int8 tensor cores: mma.sync m16n8k32 s8 -> s32 (exact),
//     corpus rows in M and queries in N, fragments by ldmatrix; each
//     consumer warp owns 8 queries (one n8 tile) and scores every row of a
//     32-row tile, so a block of 1, 2 or 4 consumer warps scores 8, 16 or
//     32 queries (at one query 7/8 of each MMA is wasted, which costs
//     nothing there: the bytes bound it); the block's queries stay in
//     shared memory;
//   - a ring of 4 tiles filled by a producer warp and drained by the
//     consumers through full / empty mbarriers, so no block barrier ties
//     the warps together: a stage is 32 whole rows of up to 256 bytes
//     (one contiguous span of the corpus for d <= 256; wider d in 256-byte
//     chunks), copied by 16-byte cp.async where rows are 16-byte aligned,
//     else 4-byte cp.async or byte loads (d % 16 != 0, a view off 16
//     bytes), zero past d in shared memory only;
//   - top-k upkeep per warp: each int score is tested in registers against
//     its list's int bound (the smallest int score whose f32 cast beats
//     the list's k-th key), one vote a tile; the rows that pass are
//     masked, keyed and appended to the warp's own list (offsets by a
//     shuffle scan, no atomics), and a list is sorted down to k
//     (warp_compact) only when the next tile could overflow it; lists live
//     in shared memory (two blocks of 32 queries an SM while k <= 160), or
//     in a global scratch where shared memory cannot hold them;
//   - l2: |x|^2 from the A fragments already in registers (dp4a, summed over
//     the quad holding a row), never per query; |q|^2 once a block.
//
// B3 (`i8_topk_kernel<..., I4 = true>`): the int8 scan's design over
// packed-int4 rows.  Bound on the H100 by the N*d/2 code bytes (0.153 ms
// over 4M x 256) or the int8 tensor cores' 2*Q*N*d operations (0.265 ms at
// Q=256): Hopper has no int4 MMA, so the nibbles go through the s8 / u8
// MMA.  The first design (split_topk_kernel: dp4a dots after a __vsub4
// unpack, 256-row tiles staged under block barriers, a block-wide bitonic
// compaction after every 64-insert round) took 20.1 ms at Q=256, k=100
// (PERF.md).  What changes from B2 int8 is the operand only: a stage holds
// 32 rows of 128 packed bytes (256 dims), the queries stay resident as the
// even and odd planes (the pre-split halves, as repro/kernels/ops.py:155
// splits them), and each packed word splits into its two nibble words in
// two instructions, two MMAs per packed K-step (the kernel's notes below).
// At Q=256, k=100 it takes 5.3 ms, the copies and mbarrier waits alone 1.5
// and the dots 1.5 more, the upkeep the rest (PERF.md, NVIDIA H100 80GB
// HBM3 at 700 W).
//
// Order: (f32 score desc under the IEEE total order, row id asc), the
// reference's (`_merge_tile` takes the first position on ties; `lax.top_k`
// is stable): every candidate is one 64-bit (score, ~id) key
// (topk_common.cuh).  Integer scores are cast to f32 before the key is
// made, as the reference casts before its merge (fused_topk.py:123): above
// 2^24, distinct int32 scores that round to one f32 become ties broken by
// id.  l2 is -(|q|^2 + |x|^2 - 2 q.x) in the accumulator type.
// Allocates nothing: the wrapper passes the scratch and the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

enum Kind { KIND_F32 = 0, KIND_I8 = 1, KIND_I4 = 2 };

__device__ __forceinline__ float finish(float dot, float qn, float xn, bool l2) {
  if (!l2) return dot;
  return -__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.0f, dot));
}

// ---- B2 fp32: the register-tiled FFMA scan ---------------------------------

// Thread layout of one config: WQ warps along queries x WR = 8 / WQ warps
// along rows; a thread holds TQ queries x TR rows of accumulators, rows
// lane + 32 j of its warp's row group, so a tile is BN = WR * 32 * TR rows.
// Each 16-byte shared load of a query (a broadcast) or a row feeds TR or
// TQ x 4 FFMA: at 4 x 8 a warp reads 12 such words for 128 FFMA.
// The ring holds 2 stages of DK floats a row, rows padded to DK + 4
// floats (16-byte reads of 8 consecutive rows hit 32 distinct banks): 16
// floats where the FFMAs bound the tile (4 queries a thread), 32 where
// the copies do (1 query a thread: fewer, larger steps keep more bytes in
// flight).  A third stage would leave room for one block an SM only.
template <int WQ, int TQ, int TR>
struct F32Cfg {
  static constexpr int WR = 8 / WQ;
  static constexpr int BQ = WQ * TQ;                // queries per block
  static constexpr int BN = WR * 32 * TR;           // corpus rows per tile
  static constexpr int DK = TQ >= 4 ? 16 : 32;      // floats a row a stage
  static constexpr int STAGES = 2;
  static constexpr int FROW = DK + 4;               // padded row stride
  static constexpr int STAGE = (BQ + BN) * FROW;    // floats per stage
  static_assert(BN % NT == 0, "a tile is a multiple of 256 rows");
};

// shared memory of one block: the ring, then (lists = bq * WR) thresholds,
// the candidate lists of `cap` keys unless they live in global memory,
// |x|^2 of the tile's rows, |q|^2, the lists' counts and the block
// compaction's flags (kernels/fused_topk.py f32_smem_bytes computes the same)
template <int WQ, int TQ, int TR>
size_t f32_smem_bytes(int cap, bool gbuf) {
  using C = F32Cfg<WQ, TQ, TR>;
  const int bq = C::BQ, lists = C::BQ * C::WR;
  return (size_t)C::STAGES * C::STAGE * 4 + (size_t)lists * 8 +
         (gbuf ? 0 : (size_t)lists * cap * 8) + (size_t)C::BN * 4 +
         (size_t)bq * 4 + (size_t)lists * 4 + (size_t)bq * 4;
}

// Stage floats [c0, c0 + DKF) of rows [row0, row0 + R) of an [n_rows, d]
// fp32 matrix row-major into dst (stride DKF + 4), zero past n_rows and d:
// 16-byte copies where `vec` (d % 4 == 0, base 16-byte aligned), else
// 4-byte copies (any d, any 4-byte aligned base).
template <int R, int DKF>
__device__ __forceinline__ void f32_stage(float* dst,
                                          const float* __restrict__ src,
                                          long long row0, long long n_rows,
                                          int d, int c0, bool vec, int tid) {
  constexpr int FROW = DKF + 4;
  if (vec) {
    constexpr int ALL = R * (DKF / 4);
#pragma unroll
    for (int j = 0; j < (ALL + NT - 1) / NT; ++j) {
      const int e = tid + j * NT;
      if (ALL % NT == 0 || e < ALL) {
        const int r = e / (DKF / 4), c = c0 + (e % (DKF / 4)) * 4;
        const bool ok = row0 + r < n_rows && c < d;
        cp_async16(dst + r * FROW + (e % (DKF / 4)) * 4,
                   ok ? src + (row0 + r) * d + c : src, ok ? 16 : 0);
      }
    }
  } else {
    constexpr int ALL = R * DKF;
#pragma unroll 4
    for (int j = 0; j < (ALL + NT - 1) / NT; ++j) {
      const int e = tid + j * NT;
      if (ALL % NT == 0 || e < ALL) {
        const int r = e / DKF, c = c0 + e % DKF;
        const bool ok = row0 + r < n_rows && c < d;
        cp_async4(dst + r * FROW + e % DKF,
                  ok ? src + (row0 + r) * d + c : src, ok ? 4 : 0);
      }
    }
  }
}

// Pass 1 of B2 fp32: grid (ceil(Q / BQ), S); block (qb, s) scores BQ
// queries against the s-th contiguous range of corpus rows, 256-row tiles
// through a F_STAGES-deep cp.async ring of DKF-float row chunks.  Each
// accumulator is one fmaf chain over d in dimension order.  Every warp
// owns its candidate lists (one per query it scores and per row group of
// the tile it covers: list query * WR + wr), so the upkeep needs no block
// barrier: at the end of a tile a warp appends each row group's surviving
// (score, row) keys to its list with one ballot, and sorts the list down to
// k (warp_compact) only when another round could overflow it.  The lists
// live in shared memory (GBUF false) or, for k too wide, in `gbuf`.
// Two blocks an SM: at one, 8 warps could not keep the FFMA pipes busy
// (8 x 8 accumulators at 64 queries a block took 252 registers and ran
// its dots at 0.37 of the peak; 4 x 8 at two blocks an SM ran them 14%
// faster, PERF.md).
template <bool L2, int WQ, int TQ, int TR, bool GBUF>
__global__ void __launch_bounds__(NT, 2)
f32_topk_kernel(const float* __restrict__ qm, const float* __restrict__ x,
                const int8_t* __restrict__ mask, u64* __restrict__ part,
                u64* __restrict__ gbuf, int Q, long long N, int d, int k,
                int cap, int n_splits, long long rows_per_split, bool x_vec,
                bool q_vec) {
  using C = F32Cfg<WQ, TQ, TR>;
  constexpr int BQ = C::BQ, WR = C::WR, LISTS = BQ * WR;
  constexpr int DKF = C::DK, F_STAGES = C::STAGES, FROW = C::FROW;
  constexpr int BN = C::BN, RPT = BN / NT;   // rows a tile, |x|^2 a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);               // [STAGES][STAGE]
  u64* thresh = reinterpret_cast<u64*>(ring + F_STAGES * C::STAGE);  // [LISTS]
  u64* lists = GBUF ? gbuf + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                 LISTS * cap
                    : thresh + LISTS;                         // [LISTS, cap]
  float* xn = reinterpret_cast<float*>(
      GBUF ? thresh + LISTS : thresh + LISTS + (size_t)LISTS * cap);  // [BN]
  float* qn = xn + BN;                                       // [BQ]
  int* cnt = reinterpret_cast<int*>(qn + BQ);                // [LISTS]
  int* need = cnt + LISTS;                                   // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp / WR, wr = warp % WR;
  const int q_base = blockIdx.x * BQ;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  auto query_of = [&](int i) { return wq * TQ + i; };
  auto row_of = [&](int j) { return wr * 32 * TR + lane + 32 * j; };

  if (tid < LISTS) {
    cnt[tid] = 0;
    thresh[tid] = 0ull;
  }
  if (tid < BQ) {
    float s = 0.0f;
    const int q = q_base + tid;
    if (L2 && q < Q)
      for (int c = 0; c < d; ++c) {
        const float v = qm[(long long)q * d + c];
        s = fmaf(v, v, s);
      }
    qn[tid] = s;
  }

  const int n_chunks = (d + DKF - 1) / DKF;
  const long long n_rows = max(0LL, r_end - r_begin);
  const int n_steps = (int)((n_rows + BN - 1) / BN) * n_chunks;
  auto load_step = [&](int s) {
    float* st = ring + (s % F_STAGES) * C::STAGE;
    const int c0 = (s % n_chunks) * DKF;
    const long long row0 = r_begin + (long long)(s / n_chunks) * BN;
    f32_stage<BQ, DKF>(st, qm, q_base, Q, d, c0, q_vec, tid);
    f32_stage<BN, DKF>(st + BQ * FROW, x, row0, r_end, d, c0, x_vec, tid);
  };
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  float acc[TQ][TR];
  float xsq[RPT];                       // |x|^2 of rows tid + NT u
  long long t0 = r_begin;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    if (s + F_STAGES - 1 < n_steps) load_step(s + F_STAGES - 1);
    cp_async_commit();
    const int c = s % n_chunks;
    if (c == 0) {
      t0 = r_begin + (long long)(s / n_chunks) * BN;
#pragma unroll
      for (int u = 0; u < RPT; ++u) xsq[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
    }
    const float* qs = ring + (s % F_STAGES) * C::STAGE;
    const float* xs = qs + BQ * FROW;
#pragma unroll
    for (int dd = 0; dd < DKF; dd += 4) {
      float4 qv[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + query_of(i) * FROW + dd);
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + row_of(j) * FROW + dd);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          acc[i][j] = fmaf(qv[i].x, xv.x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, xv.y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, xv.z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, xv.w, acc[i][j]);
        }
      }
      if (L2) {
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const float4 v =
              *reinterpret_cast<const float4*>(xs + (tid + NT * u) * FROW + dd);
          xsq[u] = fmaf(v.x, v.x, xsq[u]);
          xsq[u] = fmaf(v.y, v.y, xsq[u]);
          xsq[u] = fmaf(v.z, v.z, xsq[u]);
          xsq[u] = fmaf(v.w, v.w, xsq[u]);
        }
      }
    }
    if (c != n_chunks - 1) continue;

    // ---- epilogue of the tile at t0: warp-private, no block barrier
    // (l2 waits once for the tile's |x|^2) ----
    if (L2) {
#pragma unroll
      for (int u = 0; u < RPT; ++u) xn[tid + NT * u] = xsq[u];
      __syncthreads();
    }
    bool ok_row[TR];
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const long long row = t0 + row_of(j);
      ok_row[j] = row < r_end && (mask == nullptr || mask[row] != 0);
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = query_of(i);
      if (q_base + qi >= Q) continue;
      const int l = qi * WR + wr;
      u64* b = lists + (size_t)l * cap;
      u64 thr = thresh[l];
      int n = cnt[l];
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const u64 key = make_key(
            finish(acc[i][j], qn[qi], L2 ? xn[row_of(j)] : 0.0f, L2),
            t0 + row_of(j));
        const bool pass = ok_row[j] && key > thr;
        const unsigned m = __ballot_sync(0xffffffffu, pass);
        if (m == 0u) continue;
        if (pass) b[n + __popc(m & ((1u << lane) - 1u))] = key;
        n += __popc(m);
        if (n > cap - 32) warp_compact(b, n, thr, cap, k, lane);
      }
      __syncwarp();
      if (lane == 0) {
        cnt[l] = n;
        thresh[l] = thr;
      }
    }
  }
  cp_async_wait<0>();

  // each query's WR lists, zero-filled past their counts, are one buffer
  // of WR * cap keys: the block's compaction truncates it to the best k
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int l = query_of(i) * WR + wr;
    __syncwarp();
    const int n = cnt[l];
    for (int e = n + lane; e < cap; e += 32) lists[(size_t)l * cap + e] = 0ull;
  }
  __syncthreads();
  if (tid < BQ) {
    cnt[tid] = WR * cap;
    thresh[tid] = 0ull;
  }
  flush_partial(lists, thresh, cnt, need, BQ, WR * cap, k, part, q_base, Q,
                blockIdx.y, n_splits);
}

template <bool L2, int WQ, int TQ, int TR, bool GBUF>
cudaError_t launch_f32(const float* q, const float* x, const int8_t* mask,
                       u64* part, u64* gbuf, int Q, long long N, int d, int k,
                       int cap, int n_splits, bool x_vec, bool q_vec,
                       cudaStream_t stream) {
  using C = F32Cfg<WQ, TQ, TR>;
  const size_t smem = f32_smem_bytes<WQ, TQ, TR>(cap, GBUF);
  auto fn = f32_topk_kernel<L2, WQ, TQ, TR, GBUF>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows_per_split = (N + n_splits - 1) / n_splits;
  dim3 grid((Q + C::BQ - 1) / C::BQ, n_splits);
  fn<<<grid, NT, smem, stream>>>(q, x, mask, part, gbuf, Q, N, d, k, cap,
                                 n_splits, rows_per_split, x_vec, q_vec);
  return cudaGetLastError();
}

// the query tiles of kernels/fused_topk.py f32_query_tile: 32 (4 x 8
// accumulators a thread), 8 (1 x 8) and 1 (1 x 1, the warps along rows);
// lists in shared memory unless `gbuf` is given
template <bool L2>
cudaError_t launch_f32_bq(int bq, const float* q, const float* x,
                          const int8_t* mask, u64* part, u64* gbuf, int Q,
                          long long N, int d, int k, int cap, int n_splits,
                          bool xv, bool qv, cudaStream_t st) {
#define F32_LAUNCH(WQ_, TQ_, TR_)                                            \
  (gbuf ? launch_f32<L2, WQ_, TQ_, TR_, true>(q, x, mask, part, gbuf, Q, N, \
                                               d, k, cap, n_splits, xv, qv,  \
                                               st)                           \
        : launch_f32<L2, WQ_, TQ_, TR_, false>(q, x, mask, part, gbuf, Q, N, \
                                                d, k, cap, n_splits, xv, qv, \
                                                st))
  switch (bq) {
    case 32: return F32_LAUNCH(8, 4, 8);
    case 8: return F32_LAUNCH(8, 1, 8);
    case 1: return F32_LAUNCH(1, 1, 1);
    default: return cudaErrorInvalidValue;
  }
#undef F32_LAUNCH
}

// ---- B2 int8: the tensor-core scan with per-warp top-k upkeep ---------------

// A block is WN consumer warps scoring BQ = 8 WN queries (32, 16 or 8: the
// batch's tile, kernels/fused_topk.py i8_query_tile) and one producer
// warp: each consumer owns 8 queries (one n8 MMA tile), one candidate list
// per query, and every row of a 32-row tile (two m16 tiles).  The block's
// queries stay in shared memory for the whole scan; the ring holds
// I8_STAGES tiles of KC = 256 bytes a row (whole rows for d <= 256), rows
// KC + 16 bytes apart so ldmatrix's eight 16-byte rows hit distinct banks.
constexpr int I8_BM = 32;                 // rows a tile
constexpr int I8_MT = I8_BM / 16;         // m16 tiles a tile
constexpr int I8_STAGES = 4;

// bytes of a row a stage (KC), the staged row stride and a stage: 256
// bytes of an int8 row, 128 of a packed-int4 row (256 dims either way)
template <bool I4>
struct I8Ring {
  static constexpr int KC = I4 ? 128 : 256;
  static constexpr int SROW = KC + 16;
  static constexpr int STAGE = I8_BM * SROW;
};
constexpr int I8_KC = I8Ring<false>::KC;

// bytes of one resident query row (of one plane for int4): every KC-byte
// chunk of the row's `width` bytes, and the pad
template <bool I4>
__host__ __device__ __forceinline__ int i8_qrow(int width) {
  constexpr int KC = I8Ring<I4>::KC;
  return (width + KC - 1) / KC * KC + 16;
}

// shared memory of one block: the ring, the queries (two planes for
// int4), the ring's full and empty mbarriers, the lists' thresholds, the
// lists unless they live in global memory, |q|^2, the lists' counts, the
// flush's flags and (int4) the queries' sums (kernels/fused_topk.py
// i8_smem_bytes computes the same)
template <bool I4>
size_t i8_smem_bytes(int bq, int cap, bool gbuf, int width) {
  return (size_t)I8_STAGES * (I8Ring<I4>::STAGE + 16) +
         (size_t)(I4 ? 2 : 1) * bq * i8_qrow<I4>(width) + (size_t)bq * 8 +
         (gbuf ? 0 : (size_t)bq * cap * 8) + (size_t)bq * 4 * (I4 ? 4 : 3);
}

// the same with a u8 (unsigned) and b s8
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 1 of B2 int8: grid (ceil(Q / BQ), S); block (qb, s) scores BQ
// queries against the 32-row tiles s, s + S, s + 2 S, ... of the corpus
// (the blocks in flight read neighbouring tiles) through an
// I8_STAGES-deep ring that the producer warp fills and the
// consumer warps drain (full / empty mbarriers, no block barrier in the
// loop).  Each consumer multiplies the tile against its 8 queries with
// mma.sync m16n8k32 s8 (corpus rows in M, queries in N; s32 sums, exact;
// even and odd k-steps in two accumulator sets) and keeps |x|^2 of the rows
// from the same A fragments (dp4a, summed over the quad that holds a row).
// Its epilogue is its own: each int score is tested in registers against
// its list's bound (`int_bound`), one vote a tile; only the rows that pass
// are masked, keyed and appended to the warp's own list, and a list is
// sorted down to k (warp_compact) only when the next tile could overflow
// it.  Lists live in shared memory (GBUF false) or, for k too wide, in
// `gbuf`.  The launch bounds hold registers for two blocks of 32 queries
// an SM, or four of fewer; shared memory may allow fewer.
//
// I4 (B3): x holds packed-int4 rows of d bytes (2 d dims), qm / q1 the even
// / odd query halves (d bytes each), resident as two planes.  A stage is
// 32 rows of 128 packed bytes; ldmatrix loads packed words where the int8
// form loads codes, and each word splits in registers into its low
// nibbles (w & 0x0F0F0F0F, the even dims) and its high nibbles in place
// (w & 0xF0F0F0F0: 16 times the odd dims' nibbles), two u8 x s8 MMAs per
// packed K-step against the even and the odd query plane, into the even /
// odd accumulator sets.  Nibble n stands for n - 8, so
//   q . x = acc_lo + (acc_hi >> 4) - 8 sum(q)
// exactly (acc_hi is 16 times an int32 sum); sum(q) is taken once a block.
// Zero bytes past d unpack to nibble 0 and meet zero query bytes.  l2:
// |x|^2 = sum n (n - 16) + 64 (2 d), the sum by dp4a of each nibble word
// against itself minus 16 (n | 0xF0 as a signed byte).
template <bool L2, int WN, bool GBUF, bool I4 = false>
__global__ void __launch_bounds__(32 * (WN + 1), WN == 4 ? 2 : 4)
i8_topk_kernel(const int8_t* __restrict__ qm, const int8_t* __restrict__ q1,
               const int8_t* __restrict__ x,
               const int8_t* __restrict__ mask, u64* __restrict__ part,
               u64* __restrict__ gbuf, int Q, long long N, int d, int k,
               int cap, int n_splits, int x_mode, int q_mode) {
  constexpr int NTH = 32 * (WN + 1), BQ = 8 * WN, MT = I8_MT;
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int KC = I8Ring<I4>::KC, SROW = I8Ring<I4>::SROW;
  constexpr int STAGE = I8Ring<I4>::STAGE, PLANES = I4 ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int qrow = i8_qrow<I4>(d);
  constexpr int STAGES = I8_STAGES;
  uint8_t* qs = smem + STAGES * STAGE;                        // [PLANES, BQ, qrow]
  u64* full = reinterpret_cast<u64*>(qs + PLANES * BQ * qrow);  // [STAGES]
  u64* empty = full + STAGES;                                 // [STAGES]
  u64* thresh = empty + STAGES;                               // [BQ]
  u64* lists = GBUF ? gbuf + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                 BQ * cap
                    : thresh + BQ;                            // [BQ, cap]
  int* qn = reinterpret_cast<int*>(
      GBUF ? thresh + BQ : thresh + BQ + (size_t)BQ * cap);   // [BQ]
  int* cnt = qn + BQ;                                         // [BQ]
  int* need = cnt + BQ;                                       // [BQ]
  int* qsum = need + BQ;                                      // [BQ] (I4)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_base = blockIdx.x * BQ;

  if (tid < BQ) {
    cnt[tid] = 0;
    thresh[tid] = 0ull;
    int s = 0, sum = 0;
    const int q = q_base + tid;
    if ((L2 || I4) && q < Q)
      for (int c = 0; c < d; ++c) {
        const int v = qm[(long long)q * d + c];
        s += v * v;
        if constexpr (I4) {
          const int o = q1[(long long)q * d + c];
          s += o * o;
          sum += v + o;
        }
      }
    qn[tid] = s;
    if constexpr (I4) qsum[tid] = sum;
  }
  // this lane's two queries (the C fragment's columns 2 t4, 2 t4 + 1),
  // each its block query index and so its list
  const int l0 = warp * 8 + 2 * t4, l1 = l0 + 1;
  const bool ok0 = q_base + l0 < Q, ok1 = q_base + l1 < Q;
  int T[2] = {ok0 ? (int)0x80000000u : 0x7fffffff,
              ok1 ? (int)0x80000000u : 0x7fffffff};

  // split s scans the tiles s, s + S, s + 2 S, ...
  const int n_chunks = (d + KC - 1) / KC;
  const long long n_tiles = (N + I8_BM - 1) / I8_BM;
  const long long my_tiles =
      n_tiles > blockIdx.y ? (n_tiles - 1 - blockIdx.y) / n_splits + 1 : 0;
  const int n_steps = (int)my_tiles * n_chunks;
  auto row_of = [&](int s) {            // first row of step s's tile
    return ((long long)(s / n_chunks) * n_splits + blockIdx.y) * I8_BM;
  };
  // the queries, every chunk, once; the ring's barriers: a stage is full
  // once the producer warp's 32 lanes have landed their copies, empty once
  // each of the WN consumer warps has read it
  for (int c = 0; c < n_chunks; ++c) {
    i8_stage<BQ, NTH, KC>(qs + c * KC, qrow, qm, q_base, Q, d, c * KC, q_mode,
                          tid);
    if constexpr (I4)
      i8_stage<BQ, NTH, KC>(qs + BQ * qrow + c * KC, qrow, q1, q_base, Q, d,
                            c * KC, q_mode, tid);
  }
  cp_async_commit();
  if (tid == 0)
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], WN);
    }
  cp_async_wait<0>();
  __syncthreads();

  if (warp == WN) {
    // the producer warp: stage s goes into slot s % STAGES once the
    // consumers have emptied that slot's previous use
    for (int s = 0; s < n_steps; ++s) {
      const int slot = s % STAGES;
      if (s >= STAGES) mbar_wait(&empty[slot], (s / STAGES - 1) & 1);
      i8_stage<I8_BM, 32, KC>(smem + slot * STAGE, SROW, x, row_of(s), N,
                              d, (s % n_chunks) * KC, x_mode, lane);
      if (x_mode == 0)
        mbar_arrive(&full[slot]);
      else
        mbar_arrive_copies(&full[slot]);
    }
  }

  // ldmatrix row addresses of this lane: A (x4: rows 0-15, bytes +0 /
  // +16), B (x2: this warp's queries 0-7, bytes +0 / +16)
  const int a_off = (lane & 15) * SROW + (lane >> 4) * 16;
  const int b_off = (warp * 8 + (lane & 7)) * qrow + ((lane >> 3) & 1) * 16;
  int acc[2][MT][4];                    // even / odd k-steps: 4 MMA chains
  int xsq[MT][2];                       // |x|^2 parts of rows g, g + 8
  long long t0 = 0;
  for (int s = 0; s < (warp < WN ? n_steps : 0); ++s) {
    const int slot = s % STAGES;
    mbar_wait(&full[slot], (s / STAGES) & 1);
    const int c = s % n_chunks;
    if (c == 0) {
      t0 = row_of(s);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][mi][e] = acc[1][mi][e] = 0;
        xsq[mi][0] = xsq[mi][1] = 0;
      }
    }
    const uint8_t* As = smem + slot * STAGE + a_off;
    const uint8_t* Bs = qs + b_off + c * KC;
    const int nk = d - c * KC;          // bytes of d in this chunk
#pragma unroll
    for (int kk = 0; kk < KC / 32; ++kk) {
      if (kk * 32 >= nk) break;
      uint32_t b0, b1;
      ldsm_x2(b0, b1, Bs + kk * 32);
      if constexpr (I4) {
        uint32_t o0, o1;                // the odd query plane
        ldsm_x2(o0, o1, Bs + BQ * qrow + kk * 32);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t a[4], lo[4], hi[4];
          ldsm_x4(a, As + mi * 16 * SROW + kk * 32);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo[e] = a[e] & 0x0F0F0F0Fu;
            hi[e] = a[e] & 0xF0F0F0F0u;
          }
          mma_u8s8(acc[0][mi], lo, b0, b1);
          mma_u8s8(acc[1][mi], hi, o0, o1);
          if (L2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t h = hi[e] >> 4;
              int& xs = xsq[mi][e & 1];
              xs = __dp4a((int)lo[e], (int)(lo[e] | 0xF0F0F0F0u), xs);
              xs = __dp4a((int)h, (int)(h | 0xF0F0F0F0u), xs);
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, As + mi * 16 * SROW + kk * 32);
        mma_s8(acc[kk & 1][mi], a, b0, b1);
        if (L2) {
          xsq[mi][0] = __dp4a((int)a[0], (int)a[0], xsq[mi][0]);
          xsq[mi][0] = __dp4a((int)a[2], (int)a[2], xsq[mi][0]);
          xsq[mi][1] = __dp4a((int)a[1], (int)a[1], xsq[mi][1]);
          xsq[mi][1] = __dp4a((int)a[3], (int)a[3], xsq[mi][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (c != n_chunks - 1) continue;

    // ---- epilogue of the tile at t0: warp-private, no block barrier ----
    int qn0 = 0, qn1 = 0, qs0 = 0, qs1 = 0;
    if constexpr (I4) {
      qs0 = 8 * qsum[l0];
      qs1 = 8 * qsum[l1];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[1][mi][e] >>= 4;        // 16 x the odd dims' sum, exactly
      if (L2)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          xsq[mi][0] += 32 * d, xsq[mi][1] += 32 * d;  // a quad: 128 d
    }
    if (L2) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xsq[mi][h] += __shfl_xor_sync(FULL, xsq[mi][h], 1);
          xsq[mi][h] += __shfl_xor_sync(FULL, xsq[mi][h], 2);
        }
      qn0 = qn[l0];
      qn1 = qn[l1];
    }
    int sc[MT][4];
    bool p[MT][4], any = false;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dot = acc[0][mi][e] + acc[1][mi][e] -
                        (I4 ? (e & 1 ? qs1 : qs0) : 0);
        // l2: -(|q|^2 + |x|^2 - 2 q.x), wrapping as the reference's int32
        sc[mi][e] = L2 ? (int)(2u * (unsigned)dot - (unsigned)xsq[mi][e >> 1] -
                               (unsigned)(e & 1 ? qn1 : qn0))
                       : dot;
        p[mi][e] = sc[mi][e] >= T[e & 1];
        any |= p[mi][e];
      }
    if (!__any_sync(FULL, any)) continue;
    // the rows that pass, masked; each lane's count for its two queries,
    // and their offsets in the lists by a scan over the 8 lanes (g = 0..7)
    // that hold each query's column: no atomics
    int c0 = 0, c1 = 0;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = t0 + mi * 16 + g + (e >> 1) * 8;
        p[mi][e] = p[mi][e] && (e & 1 ? ok1 : ok0) && row < N &&
                   (mask == nullptr || mask[row] != 0);
        c0 += (e & 1) ? 0 : p[mi][e];
        c1 += (e & 1) ? p[mi][e] : 0;
      }
    int i0 = c0, i1 = c1;                 // inclusive scans over g
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const int u0 = __shfl_up_sync(FULL, i0, off);
      const int u1 = __shfl_up_sync(FULL, i1, off);
      if (lane >= off) {
        i0 += u0;
        i1 += u1;
      }
    }
    const int base0 = cnt[l0], base1 = cnt[l1];
    int w0 = base0 + i0 - c0, w1 = base1 + i1 - c1;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p[mi][e]) {
          const u64 key = make_key(__int2float_rn(sc[mi][e]),
                                   t0 + mi * 16 + g + (e >> 1) * 8);
          if (e & 1)
            lists[(size_t)l1 * cap + w1++] = key;
          else
            lists[(size_t)l0 * cap + w0++] = key;
        }
    __syncwarp();
    if (g == 7) {
      cnt[l0] = base0 + i0;
      cnt[l1] = base1 + i1;
    }
    __syncwarp();
    // a list the next tile could overflow is sorted down to k
    unsigned over = __ballot_sync(
        FULL, lane < 8 && cnt[warp * 8 + (lane & 7)] > cap - I8_BM);
    if (over == 0u) continue;
    while (over) {
      const int l = warp * 8 + __ffs(over) - 1;
      over &= over - 1u;
      int n = cnt[l];
      u64 thr = thresh[l];
      warp_compact(lists + (size_t)l * cap, n, thr, cap, k, lane);
      __syncwarp();
      if (lane == 0) {
        cnt[l] = n;
        thresh[l] = thr;
      }
      __syncwarp();
    }
    if (ok0) T[0] = int_bound(thresh[l0]);
    if (ok1) T[1] = int_bound(thresh[l1]);
  }
  cp_async_wait<0>();

  // zero-fill each list past its count; the block's compaction truncates
  // every list to its best k and writes them
#pragma unroll 1
  for (int j = 0; j < (warp < WN ? 8 : 0); ++j) {
    const int l = warp * 8 + j;
    __syncwarp();
    const int n = cnt[l];
    for (int e = n + lane; e < cap; e += 32) lists[(size_t)l * cap + e] = 0ull;
  }
  __syncthreads();
  if (tid < BQ) {
    cnt[tid] = cap;
    thresh[tid] = 0ull;
  }
  flush_partial(lists, thresh, cnt, need, BQ, cap, k, part, q_base, Q,
                blockIdx.y, n_splits);
}

// opt in to the block's shared memory, with the SM's whole carveout as
// shared memory, so that as many blocks stay resident as the layout counts
template <typename F>
cudaError_t i8_attributes(F fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// resident blocks an SM of one int8 (int4) pass-1 launch, by the
// occupancy API
template <bool L2, int WN, bool GBUF, bool I4>
int i8_occupancy(int cap, int d) {
  const size_t smem = i8_smem_bytes<I4>(8 * WN, cap, GBUF, d);
  auto fn = i8_topk_kernel<L2, WN, GBUF, I4>;
  int per_sm = 0;
  if (i8_attributes(fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * (WN + 1),
                                                    smem) != cudaSuccess)
    return -1;
  return per_sm;
}

template <bool L2, int WN, bool GBUF, bool I4>
cudaError_t launch_i8(const int8_t* q, const int8_t* q1, const int8_t* x,
                      const int8_t* mask, u64* part, u64* gbuf, int Q,
                      long long N, int d, int k, int cap, int n_splits,
                      int x_mode, int q_mode, cudaStream_t stream) {
  const size_t smem = i8_smem_bytes<I4>(8 * WN, cap, GBUF, d);
  auto fn = i8_topk_kernel<L2, WN, GBUF, I4>;
  cudaError_t err = i8_attributes(fn, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + 8 * WN - 1) / (8 * WN), n_splits);
  fn<<<grid, 32 * (WN + 1), smem, stream>>>(q, q1, x, mask, part, gbuf, Q, N,
                                            d, k, cap, n_splits, x_mode,
                                            q_mode);
  return cudaGetLastError();
}

// the query tiles of kernels/fused_topk.py i8_query_tile: 32, 16 or 8
// queries (4, 2 or 1 warps); lists in shared memory unless `gbuf` is given.
// I4: q / q1 the even / odd query halves and x packed rows, d bytes each.
template <bool L2, bool I4>
cudaError_t launch_i8_bq(int bq, const int8_t* q, const int8_t* q1,
                         const int8_t* x, const int8_t* mask, u64* part,
                         u64* gbuf, int Q, long long N, int d, int k, int cap,
                         int n_splits, cudaStream_t st) {
  const int xm = i8_copy_mode(x, d);
  int qm = i8_copy_mode(q, d);
  if (I4 && i8_copy_mode(q1, d) < qm) qm = i8_copy_mode(q1, d);
#define I8_LAUNCH(WN)                                                        \
  (gbuf ? launch_i8<L2, WN, true, I4>(q, q1, x, mask, part, gbuf, Q, N, d, \
                                      k, cap, n_splits, xm, qm, st)         \
        : launch_i8<L2, WN, false, I4>(q, q1, x, mask, part, gbuf, Q, N, d, \
                                       k, cap, n_splits, xm, qm, st))
  switch (bq) {
    case 32: return I8_LAUNCH(4);
    case 16: return I8_LAUNCH(2);
    case 8: return I8_LAUNCH(1);
    default: return cudaErrorInvalidValue;
  }
#undef I8_LAUNCH
}

// Resident int8 (i4: packed int4) pass-1 blocks an SM at bq queries a
// block, lists of `cap` keys (in global memory when gbuf is nonzero) and
// rows of `width` bytes, as the occupancy API reports it; -1 on an error.
// kernels/fused_topk.py i8_blocks_per_sm must agree (tests/test_torch_gpu.py
// checks it).
template <bool I4>
int i8_blocks(int l2, int bq, int cap, int gbuf, int width) {
#define I8_OCC(L2_, WN)                                       \
  (gbuf ? i8_occupancy<L2_, WN, true, I4>(cap, width)         \
        : i8_occupancy<L2_, WN, false, I4>(cap, width))
  const int wn = bq / 8;
  if (bq != 8 * wn || (wn != 1 && wn != 2 && wn != 4)) return -1;
  if (l2) return wn == 4 ? I8_OCC(true, 4) : wn == 2 ? I8_OCC(true, 2) : I8_OCC(true, 1);
  return wn == 4 ? I8_OCC(false, 4) : wn == 2 ? I8_OCC(false, 2) : I8_OCC(false, 1);
#undef I8_OCC
}

}  // namespace

extern "C" int rt_i8_blocks_per_sm(int l2, int bq, int cap, int gbuf,
                                   int width, int i4) {
  return i4 ? i8_blocks<true>(l2, bq, cap, gbuf, width)
            : i8_blocks<false>(l2, bq, cap, gbuf, width);
}

// kind: 0 f32 (f32_topk_kernel), 1 int8 (i8_topk_kernel) or 2 packed
// int4 (i8_topk_kernel's I4 form; q0/q1 = even/odd query halves, width =
// bytes per packed row).  The caller chooses the pass-1 layout: bq queries
// per block, a candidate buffer of `cap` keys (a power of two holding k
// kept keys plus one insert round: 32 rows for a warp's f32 list or an
// int8 / int4 tile), n_splits corpus ranges, and where
// the buffers live: `gbuf` null keeps them in shared memory, else gbuf
// holds [ceil(Q / bq) * n_splits, lists, cap] keys (lists = bq, or 8 at
// f32 bq 1).  `part` holds Q * n_splits * k keys; `mbuf` null merges in
// shared memory, else it holds [Q, next_pow2(k + NT)] keys.  Launches
// pass 1 and pass 2 on `stream` and returns the first cudaError_t (0 on
// success).
extern "C" int rt_fused_topk(int kind, int l2, int bq, int cap,
                             const void* q0, const void* q1, const void* x,
                             const void* mask, void* part, void* gbuf,
                             void* mbuf, void* out_s, void* out_i, int Q,
                             long long N, int width, int k, int n_splits,
                             void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  // room for k kept keys and one insert round: 32 rows a warp (f32), a
  // 32-row tile (int8, int4)
  const int round = kind == KIND_F32 ? 32 : I8_BM;
  if (cap != next_pow2(cap) || cap < k + round || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* m = (const int8_t*)mask;
  u64* p = (u64*)part;
  u64* g = (u64*)gbuf;
  cudaError_t err;
  if (kind == KIND_F32) {
    // 16-byte copies: d % 4 == 0 and a 16-byte aligned base
    const bool xv = width % 4 == 0 && ((uintptr_t)x & 15) == 0;
    const bool qv = width % 4 == 0 && ((uintptr_t)q0 & 15) == 0;
    const float* qf = (const float*)q0;
    const float* xf = (const float*)x;
    err = l2 ? launch_f32_bq<true>(bq, qf, xf, m, p, g, Q, N, width, k, cap, n_splits, xv, qv, st)
             : launch_f32_bq<false>(bq, qf, xf, m, p, g, Q, N, width, k, cap, n_splits, xv, qv, st);
  } else if (kind == KIND_I8) {
    const int8_t* qi = (const int8_t*)q0;
    const int8_t* xi = (const int8_t*)x;
    err = l2 ? launch_i8_bq<true, false>(bq, qi, nullptr, xi, m, p, g, Q, N, width, k, cap, n_splits, st)
             : launch_i8_bq<false, false>(bq, qi, nullptr, xi, m, p, g, Q, N, width, k, cap, n_splits, st);
  } else if (kind == KIND_I4) {
    if (q1 == nullptr) return (int)cudaErrorInvalidValue;
    const int8_t* qe = (const int8_t*)q0;
    const int8_t* qo = (const int8_t*)q1;
    const int8_t* xi = (const int8_t*)x;
    err = l2 ? launch_i8_bq<true, true>(bq, qe, qo, xi, m, p, g, Q, N, width, k, cap, n_splits, st)
             : launch_i8_bq<false, true>(bq, qe, qo, xi, m, p, g, Q, N, width, k, cap, n_splits, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(p, (u64*)mbuf, out_s, out_i, Q, n_splits, k, st);
}

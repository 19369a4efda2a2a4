// B4 and B5: fused ADC (asymmetric distance computation) scan + running
// top-k over product-quantization codes.
//
// Replaces the TPU kernels repro/kernels/adc.py `fused_adc_pallas` (B4:
// [Q, M*256] int8 LUT x [N, M] uint8 codewords; `make_adc_tile`,
// `_onehot_codes`) and `fused_adc4_pallas` (B5: 16-codeword codebooks,
// codes packed two per byte, scored against the even/odd LUT halves;
// `make_adc4_tile`), both of which feed the running top-k `_merge_tile` of
// repro/kernels/fused_topk.py.  What carries over is what they compute:
//
//   s[q, n] = sum_m lut[q, m, codes[n, m]]        (exact int32)
//
// for every corpus row and query, rows with id >= n_valid or a zero [N]
// mask entry never returned, the best k per query kept, the [Q, N] ADC
// matrix never written to device memory.  Two pass-1 kernels:
//
//   adc_split_kernel (B4; B5's batches of at most 4 queries and rows too
//     wide for adc4_mma_kernel): the gather out of shared memory.  Grid
//     (ceil(Q/BQ), S), the layout of B2's first pass 1.  Block (qb, s)
//     copies the int8 LUTs of its BQ queries into shared memory once, laid
//     out [subspace][query][codeword] so that one code's entries for the
//     block's queries sit K bytes apart (a compile-time offset per query),
//     then streams the s-th contiguous range of code rows in tiles of
//     BN=256 rows, staged in shared memory (16-byte loads where rows
//     allow).  A thread scores TR=4 rows for TQ=BQ/4 queries in int32
//     registers: per code, one shared-memory byte gather and one add per
//     query.  B5 splits the nibbles in registers: nibble t of a packed
//     code word is subspace 8w+t, the low nibble of a byte the even
//     subspace (its row of lut_even), the high one the odd subspace
//     (lut_odd), as repro/kernels/ops.py:334-335 splits the LUT.  The
//     candidate buffers, the threshold test on whole (score, ~id) keys and
//     the bitonic compaction are topk_common.cuh's: a tie at the threshold
//     is decided by id and cannot flood a buffer, which matters here
//     because ADC scores are small integers (|s| <= 128*M) and many rows
//     share the k-th score.
//   adc4_mma_kernel (B5 from 5 queries on): the TPU kernel's own one-hot
//     form on the int8 tensor cores (notes at the kernel).
//   pass 2: topk_common.cuh's merge, one block per query.
//
// The Python wrapper (kernels/adc.py `adc_layout`) is the one place that
// chooses the kernel and the layout, so that any k <= N and any M launch.
// The gather kernel takes BQ 16, 8, 4, 2 or 1 so that the BQ LUTs (M*K
// bytes each: 8 KB at M=32, K=256) plus the BQ candidate buffers (8*cap
// bytes each) fit in the 227 KB of shared memory; failing that, the
// buffers in a global scratch (GBUF); failing that (B4 past about M = 800,
// B5's rows past about 864 bytes), the LUTs read from global memory
// through L2 (LUTG, 4 queries a block).  Below 4 queries a block the 256
// threads form BQ query groups of 256 / BQ row lanes, so a tile is 512 or
// 1024 rows and an insert round NT / BQ candidates a query; `cap` holds k
// plus one round.
//
// Bound on the H100: operations for a full query bucket (Q*N*M int32
// adds, the table's yardstick; B5's one-hot form does 2*Q*N*16M int8
// operations on the tensor cores instead, 1.09 ms at pq64x4, Q=256, N=4M),
// bytes for a single request (N*M code bytes at 3.35 TB/s).  The gather
// pays one shared-memory byte load per (query, row, subspace): with K=256
// the 32 lanes of a warp gather from one 256-byte LUT row, i.e. 64 words
// over 32 banks, so random codes cost a few-way bank conflict; with K=16
// (B5) a row is 4 words in 4 banks and the gathers are conflict-free.
// Integer scores are exact; each is cast to f32 (__int2float_rn) before
// its key is made, as the reference casts before its merge.  Allocates
// nothing: the wrapper passes the [Q, S, k] partial-key scratch and the
// outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int TR = 4;                   // corpus rows per thread per tile
constexpr int DKC = 8;                  // 32-bit code words per chunk
constexpr int CS_STRIDE = DKC + 1;      // odd stride: conflict-free rows

// word w (4 code bytes, little-endian) of a code row of mb bytes, zero past
// the end of the row
__device__ __forceinline__ uint32_t code_word(const uint8_t* row, int mb,
                                              int w, bool aligned) {
  if (aligned) return reinterpret_cast<const uint32_t*>(row)[w];
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int idx = 4 * w + b;
    if (idx < mb) v |= (uint32_t)row[idx] << (8 * b);
  }
  return v;
}

// Rows a pass-1 tile holds at BQ queries a block: the 256 threads form
// QG = min(BQ, 4) query groups of NT / QG row lanes with TR rows each, so
// a tile is 256 rows at BQ >= 4 and 512 / 1024 at BQ = 2 / 1.
constexpr int tile_rows(int bq) { return NT / (bq < 4 ? bq : 4) * TR; }

// shared-memory bytes of one pass-1 block (kernels/adc.py smem_bytes
// computes the same): no candidate buffers when they live in global
// memory (gbuf), no LUTs when they are read from global memory (lutg)
size_t split_smem_bytes(int bq, int cap, int s_pad, int K, bool gbuf,
                        bool lutg) {
  return (gbuf ? 0 : (size_t)bq * cap * 8) + (size_t)bq * 8 +
         (lutg ? 0 : (size_t)s_pad * bq * K) +
         (size_t)tile_rows(bq) * CS_STRIDE * 4 + (size_t)bq * 4 * 2;
}

// GBUF: the [BQ, cap] candidate buffers live in `gbuf` (global memory, one
// slice a block) for k whose buffers do not fit in shared memory.  LUTG:
// the LUTs are read from global memory (through L2) for M so wide that
// even one query's LUT does not fit in shared memory.
template <int KBITS, int BQ, bool GBUF, bool LUTG>
__global__ void __launch_bounds__(NT)
adc_split_kernel(const int8_t* __restrict__ lut0,
                 const int8_t* __restrict__ lut1,
                 const uint8_t* __restrict__ codes,
                 const int8_t* __restrict__ mask, u64* __restrict__ part,
                 u64* __restrict__ gbuf, int Q, long long N, int mb, int k,
                 int cap, int n_splits, long long rows_per_split,
                 bool codes_aligned, bool codes_vec) {
  constexpr int K = 1 << KBITS;          // codewords per subspace
  constexpr int KW = K / 4;              // LUT words per (subspace, query)
  constexpr int CPW = 32 / KBITS;        // codes per 32-bit code word
  constexpr int QG = BQ < 4 ? BQ : 4;    // query groups
  constexpr int TQ = BQ / QG;            // queries per thread
  constexpr int RL = NT / QG;            // row lanes of a query group
  constexpr int BN = RL * TR;            // code rows per tile
  const int W = (mb + 3) / 4;            // code words per row
  const int S = KBITS == 8 ? mb : 2 * mb;  // subspaces the LUT covers
  const int s_pad = W * CPW;             // subspaces the code words hold

  extern __shared__ __align__(16) unsigned char smem[];
  u64* sbase = reinterpret_cast<u64*>(smem);
  u64* buf = GBUF ? gbuf + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                               BQ * cap
                  : sbase;                                     // [BQ, cap]
  u64* thresh = GBUF ? sbase : sbase + (size_t)BQ * cap;       // [BQ]
  int8_t* lut_s = reinterpret_cast<int8_t*>(thresh + BQ);      // [s_pad, BQ, K]
  uint32_t* cs = reinterpret_cast<uint32_t*>(
      lut_s + (LUTG ? 0 : (size_t)s_pad * BQ * K));
  int* cnt = reinterpret_cast<int*>(cs + BN * CS_STRIDE);      // [BQ]
  int* need = cnt + BQ;                                        // [BQ]

  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);

  if (tid < BQ) {
    cnt[tid] = 0;
    thresh[tid] = 0ull;
  }
  const long long row_w = (long long)mb * KW;   // LUT words per query row
  if (!LUTG) {
    // the block's LUTs, [subspace][query][codeword]; zero for queries past
    // Q and for the subspaces past S that the last code word's pad bytes
    // index (those bytes are zero too)
    uint32_t* lut_w = reinterpret_cast<uint32_t*>(lut_s);
    for (int e = tid; e < s_pad * BQ * KW; e += NT) {
      const int s = e / (BQ * KW);
      const int rem = e - s * (BQ * KW);
      const int qi = rem / KW, cw = rem - qi * KW;
      const int q = q_base + qi;
      uint32_t v = 0;
      if (q < Q && s < S) {
        const int8_t* src = KBITS == 8 ? lut0 : ((s & 1) ? lut1 : lut0);
        const int sub = KBITS == 8 ? s : (s >> 1);
        v = reinterpret_cast<const uint32_t*>(src)[q * row_w + (long long)sub * KW + cw];
      }
      lut_w[e] = v;
    }
  }

  const int qg = tid / RL;
  const int lane = tid % RL;
  const int8_t* lut_g = lut_s + qg * TQ * K;   // this thread's query group
  // LUTG: this thread's queries' LUT rows in global memory (a query past Q
  // reads query Q - 1's; its scores are never offered)
  const int8_t* lq0[TQ];
  const int8_t* lq1[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const long long q = min(q_base + qg * TQ + i, Q - 1);
    lq0[i] = lut0 + q * row_w * 4;
    lq1[i] = KBITS == 4 ? lut1 + q * row_w * 4 : lut0;
  }

  for (long long t0 = r_begin; t0 < r_end; t0 += BN) {
    int acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0;

    for (int c0 = 0; c0 < W; c0 += DKC) {
      __syncthreads();
      if (codes_vec) {
        // rows of a multiple of 16 bytes: all 16-byte loads of the chunk in
        // flight before the first shared store
        constexpr int VPR = DKC / 4;           // uint4 per row per chunk
        constexpr int VPT = BN * VPR / NT;     // uint4 per thread
        uint4 v[VPT];
#pragma unroll
        for (int it = 0; it < VPT; ++it) {
          const int e = tid + it * NT, r = e / VPR, w = c0 + 4 * (e % VPR);
          v[it] = make_uint4(0u, 0u, 0u, 0u);
          if (t0 + r < r_end && w < W)
            v[it] = *reinterpret_cast<const uint4*>(
                reinterpret_cast<const uint32_t*>(codes) + (t0 + r) * W + w);
        }
#pragma unroll
        for (int it = 0; it < VPT; ++it) {
          const int e = tid + it * NT;
          uint32_t* dst = cs + (e / VPR) * CS_STRIDE + 4 * (e % VPR);
          dst[0] = v[it].x;
          dst[1] = v[it].y;
          dst[2] = v[it].z;
          dst[3] = v[it].w;
        }
      } else {
        for (int e = tid; e < BN * DKC; e += NT) {
          const int r = e / DKC, w = e % DKC;
          const long long row = t0 + r;
          uint32_t v = 0;
          if (row < r_end && c0 + w < W)
            v = code_word(codes + row * mb, mb, c0 + w, codes_aligned);
          cs[r * CS_STRIDE + w] = v;
        }
      }
      __syncthreads();
      const int nw = min(DKC, W - c0);
#pragma unroll 2
      for (int w = 0; w < nw; ++w) {
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const uint32_t word = cs[(lane + j * RL) * CS_STRIDE + w];
#pragma unroll
          for (int b = 0; b < CPW; ++b) {
            const int code = (word >> (KBITS * b)) & (K - 1);
            const int s = (c0 + w) * CPW + b;
            if (LUTG) {
              if (s < S) {
                const int sub = KBITS == 8 ? s : (s >> 1);
#pragma unroll
                for (int i = 0; i < TQ; ++i)
                  acc[i][j] += __ldg((KBITS == 4 && (s & 1) ? lq1[i] : lq0[i])
                                     + (long long)sub * K + code);
              }
            } else {
              const int8_t* p = lut_g + s * (BQ * K) + code;
#pragma unroll
              for (int i = 0; i < TQ; ++i) acc[i][j] += p[i * K];
            }
          }
        }
      }
    }

    // insert in TR rounds: at most RL candidates per query per round, and
    // cap >= k + RL, so a buffer compacted to k between rounds never
    // overflows
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const long long row = t0 + lane + j * RL;
      const bool ok_row = row < r_end && (mask == nullptr || mask[row] != 0);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = qg * TQ + i;
        if (ok_row && q_base + qi < Q)
          offer(buf, thresh, cnt, qi, cap,
                make_key(__int2float_rn(acc[i][j]), row));
      }
      compact(buf, thresh, cnt, need, BQ, cap, k, cap - RL);
    }
  }

  flush_partial(buf, thresh, cnt, need, BQ, cap, k, part, q_base, Q, split,
                n_splits);
}

template <int KBITS, int BQ, bool GBUF, bool LUTG>
cudaError_t launch_split(const int8_t* lut0, const int8_t* lut1,
                         const uint8_t* codes, const int8_t* mask, u64* part,
                         u64* gbuf, int Q, long long N, int mb, int k,
                         int cap, int n_splits, bool aligned, bool vec,
                         cudaStream_t stream) {
  const int s_pad = ((mb + 3) / 4) * (32 / KBITS);
  const size_t smem =
      split_smem_bytes(BQ, cap, s_pad, 1 << KBITS, GBUF, LUTG);
  auto fn = adc_split_kernel<KBITS, BQ, GBUF, LUTG>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows_per_split = (N + n_splits - 1) / n_splits;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  fn<<<grid, NT, smem, stream>>>(lut0, lut1, codes, mask, part, gbuf, Q, N,
                                 mb, k, cap, n_splits, rows_per_split,
                                 aligned, vec);
  return cudaGetLastError();
}

// B5's layouts on the gather kernel (kernels/adc.py adc_layout): BQ 4, 2
// or 1 with the LUTs in shared memory (batches of at most 4 queries), or
// BQ 4 with the LUTs in global memory (rows too wide for adc4_mma_kernel)
template <bool GBUF>
cudaError_t launch_split4(int bq, bool lutg, const int8_t* lut0,
                          const int8_t* lut1, const uint8_t* codes,
                          const int8_t* mask, u64* part, u64* gbuf, int Q,
                          long long N, int mb, int k, int cap, int n_splits,
                          bool aligned, bool vec, cudaStream_t st) {
#define ADC4_LAUNCH(BQ_, LUTG_)                                              \
  launch_split<4, BQ_, GBUF, LUTG_>(lut0, lut1, codes, mask, part, gbuf, Q, \
                                    N, mb, k, cap, n_splits, aligned, vec,  \
                                    st)
  if (lutg) return bq == 4 ? ADC4_LAUNCH(4, true) : cudaErrorInvalidValue;
  switch (bq) {
    case 4: return ADC4_LAUNCH(4, false);
    case 2: return ADC4_LAUNCH(2, false);
    case 1: return ADC4_LAUNCH(1, false);
    default: return cudaErrorInvalidValue;
  }
#undef ADC4_LAUNCH
}

// B4's layouts (kernels/adc.py adc_layout): BQ 16, 8, 4, 2 or 1 with the
// LUTs in shared memory (buffers in shared or global memory), or BQ 4 with
// the LUTs in global memory
template <int KBITS, bool GBUF>
cudaError_t launch_split_bq(int bq, bool lutg, const int8_t* lut0,
                            const int8_t* lut1, const uint8_t* codes,
                            const int8_t* mask, u64* part, u64* gbuf, int Q,
                            long long N, int mb, int k, int cap, int n_splits,
                            bool aligned, bool vec, cudaStream_t st) {
#define ADC_LAUNCH(BQ_, LUTG_)                                               \
  launch_split<KBITS, BQ_, GBUF, LUTG_>(lut0, lut1, codes, mask, part, gbuf, \
                                        Q, N, mb, k, cap, n_splits, aligned, \
                                        vec, st)
  if (lutg) return bq == 4 ? ADC_LAUNCH(4, true) : cudaErrorInvalidValue;
  switch (bq) {
    case 16: return ADC_LAUNCH(16, false);
    case 8: return ADC_LAUNCH(8, false);
    case 4: return ADC_LAUNCH(4, false);
    case 2: return ADC_LAUNCH(2, false);
    case 1: return ADC_LAUNCH(1, false);
    default: return cudaErrorInvalidValue;
  }
#undef ADC_LAUNCH
}

// ---- B5: the one-hot form on the int8 tensor cores -------------------------

// A block is WN consumer warps scoring BQ = 8 WN queries (32, 16 or 8: the
// batch's tile, kernels/adc.py a4_query_tile) and one producer warp: each
// consumer owns 8 queries (one n8 MMA tile), one candidate list per query,
// and every row of a 32-row tile (two m16 tiles), as B2 int8's.  A warp of
// 16 or 32 queries would share each one-hot register among more MMAs, but
// the lists and LUTs (3 KB a query at k <= 160) then leave 4 or 2 warps an
// SM, too few to hide the latency of one warp's dependent steps; 8 warps
// an SM of 8 queries each scanned faster (PERF.md).  The block's
// LUTs stay in shared memory for the whole scan,
// interleaved per code byte: query q's row holds, for code byte j,
// lut_even[q, j, 0..15] then lut_odd[q, j, 0..15] (32 bytes: one k32
// step), rows 32 mb' + 16 bytes apart (mb' = mb rounded up to 16) so
// ldmatrix's eight 16-byte rows hit distinct banks.  The ring holds
// A4_STAGES tiles of A4_KCB code bytes a row (whole rows for mb <= 64),
// rows A4_KCB + 16 bytes apart so the 16-byte reads of eight rows hit
// distinct banks.
constexpr int A4_BM = 32;                 // rows a tile
constexpr int A4_MT = A4_BM / 16;         // m16 tiles a tile
constexpr int A4_KCB = 64;                // code bytes of a row a stage
constexpr int A4_SROW = A4_KCB + 16;      // staged row stride
constexpr int A4_STAGES = 4;
constexpr int A4_STAGE = A4_BM * A4_SROW;

// bytes of one query's resident LUT row: 32 a code byte, zero past mb to a
// multiple of 16 code bytes (the steps of the last 16-byte code read), and
// the pad
__host__ __device__ __forceinline__ int a4_qrow(int mb) {
  return 32 * ((mb + 15) / 16 * 16) + 16;
}

// shared memory of one block: the ring and its mbarriers, the LUTs, the
// lists' thresholds, the lists unless they live in global memory, the
// lists' counts and the flush's flags (kernels/adc.py a4_smem_bytes
// computes the same)
size_t a4_smem_bytes(int bq, int cap, bool gbuf, int mb) {
  return (size_t)A4_STAGES * (A4_STAGE + 16) + (size_t)bq * a4_qrow(mb) +
         (size_t)bq * 8 + (gbuf ? 0 : (size_t)bq * cap * 8) +
         (size_t)bq * 4 * 2;
}

// The one-hot A register of a code: `sh` is 8 c ^ 32 t4 for codeword c and
// this lane's K group t4, so the byte c & 3 of the result is 1 exactly when
// c lies in [4 t4, 4 t4 + 4): shl.b32 clamps a shift past 31 to a zero
// result, so the range test costs no branch.
__device__ __forceinline__ uint32_t onehot(uint32_t sh) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(1u), "r"(sh));
  return r;
}

// Pass 1 of B5: grid (ceil(Q / BQ), S); block (qb, s) scores BQ queries
// against the 32-row tiles s, s + S, s + 2 S, ... of the code matrix
// through an A4_STAGES-deep ring that the producer warp fills and the
// consumer warps drain (full / empty mbarriers, no block barrier in the
// loop).  The sum over subspaces is an int8 product, the reference TPU
// kernel's own form (`_onehot_codes`): s[q, n] = sum_K onehot[n, K] *
// lut[q, K] with K = 32 mb, one mma.sync m16n8k32 s8 step per code byte
// (corpus rows in M, queries in N; s32 sums, exact).  The one-hot operand
// never leaves registers: a lane builds its A registers from the code
// bytes of its rows g, g + 8 (16 bytes read once for 16 steps) in two
// instructions a register (prmt, shl).  The LUT operand comes from shared
// memory by ldmatrix, one load a step, shared by the two m16 tiles.  The
// epilogue and the lists are B2 int8's (fused_topk.cu i8_topk_kernel):
// each int score tested in registers against its list's bound, one vote a
// tile, the passing rows appended to the warp's own lists, a list sorted
// down to k only when the next tile could overflow it.  A design with the
// block's four warps sharing 32 queries (each one-hot register feeding
// four MMAs) and their lists under locks ran faster on random LUTs, but
// its tiles all took the locked append path and, on LUTs whose scores
// tie at the k-th, flooded the lists (PERF.md).
template <int WN, bool GBUF>
__global__ void __launch_bounds__(32 * (WN + 1), WN == 4 ? 2 : 4)
adc4_mma_kernel(const int8_t* __restrict__ lut0,
                const int8_t* __restrict__ lut1,
                const uint8_t* __restrict__ codes,
                const int8_t* __restrict__ mask, u64* __restrict__ part,
                u64* __restrict__ gbuf, int Q, long long N, int mb, int k,
                int cap, int n_splits, int c_mode, int l_mode) {
  constexpr int NTH = 32 * (WN + 1), BQ = 8 * WN;
  constexpr int MT = A4_MT, STAGES = A4_STAGES;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) uint8_t smem[];
  const int qrow = a4_qrow(mb);
  uint8_t* lut = smem + STAGES * A4_STAGE;                    // [BQ, qrow]
  u64* full = reinterpret_cast<u64*>(lut + BQ * qrow);        // [STAGES]
  u64* empty = full + STAGES;                                 // [STAGES]
  u64* thresh = empty + STAGES;                               // [BQ]
  u64* lists = GBUF ? gbuf + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                 BQ * cap
                    : thresh + BQ;                            // [BQ, cap]
  int* cnt = reinterpret_cast<int*>(
      GBUF ? thresh + BQ : thresh + BQ + (size_t)BQ * cap);   // [BQ]
  int* need = cnt + BQ;                                       // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_base = blockIdx.x * BQ;
  if (tid < BQ) {
    cnt[tid] = 0;
    thresh[tid] = 0ull;
  }
  // the block's LUTs, once: 16 bytes of lut_even / lut_odd per (query,
  // code byte, half), zero for queries past Q and code bytes past mb
  const int mbp = (mb + 15) / 16 * 16;
  for (int u = tid; u < BQ * mbp * 2; u += NTH) {
    const int qi = u / (2 * mbp), j = (u >> 1) - qi * mbp, half = u & 1;
    const int q = q_base + qi;
    uint8_t* dst = lut + qi * qrow + 32 * j + 16 * half;
    const int8_t* src = (half ? lut1 : lut0) + ((long long)q * mb + j) * 16;
    const bool ok = q < Q && j < mb;
    if (l_mode == 2) {
      cp_async16(dst, ok ? src : lut0, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        cp_async4(dst + 4 * w, ok ? src + 4 * w : lut0, ok ? 4 : 0);
    }
  }
  cp_async_commit();
  if (tid == 0)
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], WN);
    }
  cp_async_wait<0>();
  __syncthreads();

  // split s scans the tiles s, s + S, s + 2 S, ...
  const int n_chunks = (mb + A4_KCB - 1) / A4_KCB;
  const long long n_tiles = (N + A4_BM - 1) / A4_BM;
  const long long my_tiles =
      n_tiles > blockIdx.y ? (n_tiles - 1 - blockIdx.y) / n_splits + 1 : 0;
  const int n_steps = (int)my_tiles * n_chunks;
  auto row_of = [&](int s) {            // first row of step s's tile
    return ((long long)(s / n_chunks) * n_splits + blockIdx.y) * A4_BM;
  };
  const int8_t* cb = reinterpret_cast<const int8_t*>(codes);
  if (warp == WN) {
    for (int s = 0; s < n_steps; ++s) {
      const int slot = s % STAGES;
      if (s >= STAGES) mbar_wait(&empty[slot], (s / STAGES - 1) & 1);
      i8_stage<A4_BM, 32, A4_KCB>(smem + slot * A4_STAGE, A4_SROW, cb,
                                  row_of(s), N, mb, (s % n_chunks) * A4_KCB,
                                  c_mode, lane);
      if (c_mode == 0)
        mbar_arrive(&full[slot]);
      else
        mbar_arrive_copies(&full[slot]);
    }
  }

  // this lane's two queries (the C fragment's columns 2 t4, 2 t4 + 1),
  // each its block query index and so its list
  const int l0 = warp * 8 + 2 * t4, l1 = l0 + 1;
  const bool ok0 = q_base + l0 < Q, ok1 = q_base + l1 < Q;
  int T[2] = {ok0 ? (int)0x80000000u : 0x7fffffff,
              ok1 ? (int)0x80000000u : 0x7fffffff};
  const uint32_t kgroup = 0x20202020u * t4;   // 32 t4 in every byte
  // ldmatrix row addresses of this lane (x2: this warp's queries 0-7,
  // bytes +0 / +16 of a step)
  const uint8_t* Bl = lut + (warp * 8 + (lane & 7)) * qrow +
                     ((lane >> 3) & 1) * 16;
  int acc[MT][4];
  long long t0 = 0;
  for (int s = 0; s < (warp < WN ? n_steps : 0); ++s) {
    const int slot = s % STAGES;
    mbar_wait(&full[slot], (s / STAGES) & 1);
    const int c = s % n_chunks;
    if (c == 0) {
      t0 = row_of(s);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][e] = 0;
    }
    const uint8_t* rows = smem + slot * A4_STAGE + g * A4_SROW;
    const uint8_t* Bs = Bl + 32 * c * A4_KCB;
    // code bytes of this chunk, in steps of 16: past mb the staged codes
    // are 0 and the LUT rows zero, so a step there adds nothing
    const int nk = min(A4_KCB, mb - c * A4_KCB);
#pragma unroll 1
    for (int kb = 0; kb < nk; kb += 16) {
      uint4 w[2 * MT];                  // 16 code bytes of rows g + 8 r
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r)
        w[r] = *reinterpret_cast<const uint4*>(rows + 8 * r * A4_SROW + kb);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        uint32_t b0, b1;                // the step's LUT fragments
        ldsm_x2(b0, b1, Bs + 32 * (kb + jj));
        // per row: 8 c ^ 32 t4 of the even (low) and odd (high) code of
        // this step's byte, byte jj % 4 of its code word
        const int wq = jj >> 2;
        const uint32_t sel = 0x4440u + (jj & 3);  // that byte, zeros above
        uint32_t se[2 * MT], so[2 * MT];
#pragma unroll
        for (int r = 0; r < 2 * MT; ++r) {
          const uint32_t x = wq == 0 ? w[r].x : wq == 1 ? w[r].y
                           : wq == 2 ? w[r].z : w[r].w;
          se[r] = ((x << 3) & 0x78787878u) ^ kgroup;
          so[r] = ((x >> 1) & 0x78787878u) ^ kgroup;
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t a[4];
          a[0] = onehot(__byte_perm(se[2 * mi], 0u, sel));
          a[1] = onehot(__byte_perm(se[2 * mi + 1], 0u, sel));
          a[2] = onehot(__byte_perm(so[2 * mi], 0u, sel));
          a[3] = onehot(__byte_perm(so[2 * mi + 1], 0u, sel));
          mma_s8(acc[mi], a, b0, b1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (c != n_chunks - 1) continue;

    // ---- epilogue of the tile at t0: warp-private, no block barrier ----
    bool p[MT][4], any = false;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[mi][e] = acc[mi][e] >= T[e & 1];
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
          const u64 key = make_key(__int2float_rn(acc[mi][e]),
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
        FULL, lane < 8 && cnt[warp * 8 + (lane & 7)] > cap - A4_BM);
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
cudaError_t a4_attributes(F fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int WN, bool GBUF>
cudaError_t launch_a4(const int8_t* lut0, const int8_t* lut1,
                      const uint8_t* codes, const int8_t* mask, u64* part,
                      u64* gbuf, int Q, long long N, int mb, int k, int cap,
                      int n_splits, int c_mode, int l_mode,
                      cudaStream_t stream) {
  const size_t smem = a4_smem_bytes(8 * WN, cap, GBUF, mb);
  auto fn = adc4_mma_kernel<WN, GBUF>;
  cudaError_t err = a4_attributes(fn, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + 8 * WN - 1) / (8 * WN), n_splits);
  fn<<<grid, 32 * (WN + 1), smem, stream>>>(lut0, lut1, codes, mask, part,
                                            gbuf, Q, N, mb, k, cap, n_splits,
                                            c_mode, l_mode);
  return cudaGetLastError();
}

// resident blocks an SM of one B5 pass-1 launch, by the occupancy API
template <int WN, bool GBUF>
int a4_occupancy(int cap, int mb) {
  const size_t smem = a4_smem_bytes(8 * WN, cap, GBUF, mb);
  auto fn = adc4_mma_kernel<WN, GBUF>;
  int per_sm = 0;
  if (a4_attributes(fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * (WN + 1),
                                                    smem) != cudaSuccess)
    return -1;
  return per_sm;
}

// the query tiles of kernels/adc.py a4_query_tile: 32, 16 or 8 queries (4,
// 2 or 1 warps); lists in shared memory unless `gbuf` is given
#define A4_CASES(X)            \
  switch (bq) {                \
    case 32: return X(4);      \
    case 16: return X(2);      \
    case 8: return X(1);       \
    default: break;            \
  }

cudaError_t launch_a4_bq(int bq, const int8_t* lut0, const int8_t* lut1,
                         const uint8_t* codes, const int8_t* mask, u64* part,
                         u64* gbuf, int Q, long long N, int mb, int k, int cap,
                         int n_splits, cudaStream_t st) {
  const int cm = i8_copy_mode(codes, mb);
  const int lm = (((uintptr_t)lut0 | (uintptr_t)lut1) & 15) == 0 ? 2 : 1;
#define A4_LAUNCH(WN)                                                       \
  (gbuf ? launch_a4<WN, true>(lut0, lut1, codes, mask, part, gbuf, Q, N,   \
                              mb, k, cap, n_splits, cm, lm, st)             \
        : launch_a4<WN, false>(lut0, lut1, codes, mask, part, gbuf, Q, N,  \
                               mb, k, cap, n_splits, cm, lm, st))
  A4_CASES(A4_LAUNCH)
#undef A4_LAUNCH
  return cudaErrorInvalidValue;
}

int a4_blocks(int bq, int cap, int gbuf, int mb) {
#define A4_OCC(WN)                                           \
  (gbuf ? a4_occupancy<WN, true>(cap, mb)                    \
        : a4_occupancy<WN, false>(cap, mb))
  A4_CASES(A4_OCC)
#undef A4_OCC
  return -1;
}
#undef A4_CASES

}  // namespace

// Resident B5 pass-1 blocks an SM at bq queries a block, lists of `cap`
// keys (in global memory when gbuf is nonzero) and code rows of mb bytes,
// as the occupancy API reports it; -1 on an error.  kernels/adc.py
// a4_blocks_per_sm must agree (tests/test_torch_gpu.py checks it).
extern "C" int rt_adc4_blocks_per_sm(int bq, int cap, int gbuf, int mb) {
  return a4_blocks(bq, cap, gbuf, mb);
}

// kbits 8 (B4): lut0 = [Q, mb*256] int8 LUT, lut1 unused, codes [N, mb]
// uint8 codewords.  kbits 4 (B5): lut0 / lut1 = [Q, mb*16] int8 even / odd
// subspace LUT halves, codes [N, mb] uint8 packed nibbles (low = even
// subspace).  The caller chooses the pass-1 layout: bq queries per block,
// the kernel and where its LUTs live (`mode`: bit 0, the LUTs read from
// global memory, B4's wide-M layout and B5's rows too wide for 8 queries'
// LUTs in shared memory, at bq 4; bit 1, B5 on adc_split_kernel, which
// batches of at most 4 queries take; B5 otherwise, mode 0, runs
// adc4_mma_kernel at bq 8, 16, 32 or 64), a candidate buffer of `cap` keys
// per query (a power of two holding k kept keys plus one round of
// inserts: NT / min(bq, 4) rows for adc_split_kernel, a 32-row tile for
// adc4_mma_kernel), n_splits corpus ranges, and where the buffers live:
// `gbuf` null keeps them in shared memory, else gbuf holds
// [ceil(Q / bq) * n_splits, bq, cap] keys.  `part` holds Q * n_splits * k
// keys; `mbuf` null merges in shared memory, else it holds
// [Q, next_pow2(k + NT)] keys.  Launches pass 1 and pass 2 on `stream` and
// returns the first cudaError_t (0 on success).
extern "C" int rt_fused_adc(int kbits, int bq, int mode, int cap,
                            const void* lut0, const void* lut1,
                            const void* codes, const void* mask, void* part,
                            void* gbuf, void* mbuf, void* out_s, void* out_i,
                            int Q, long long N, int mb, int k, int n_splits,
                            void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  const bool lutg = mode & 1;
  const bool mma = kbits == 4 && mode == 0;   // B5 on adc4_mma_kernel
  const int round = mma ? A4_BM : NT / (bq < 4 ? bq : 4);
  if (bq <= 0 || cap != next_pow2(cap) || cap < k + round || n_splits <= 0 ||
      mb <= 0 || ((uintptr_t)lut0 & 3) != 0 ||
      (kbits == 4 && (lut1 == nullptr || ((uintptr_t)lut1 & 3) != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = mb % 4 == 0 && ((uintptr_t)codes & 3) == 0;
  const bool vec = mb % 16 == 0 && ((uintptr_t)codes & 15) == 0;
  const int8_t* l0 = (const int8_t*)lut0;
  const int8_t* l1 = (const int8_t*)lut1;
  const uint8_t* c = (const uint8_t*)codes;
  const int8_t* m = (const int8_t*)mask;
  u64* p = (u64*)part;
  u64* g = (u64*)gbuf;
  cudaError_t err;
  if (kbits == 8)
    err = g ? launch_split_bq<8, true>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, aligned, vec, st)
            : launch_split_bq<8, false>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, aligned, vec, st);
  else if (mma)
    err = launch_a4_bq(bq, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, st);
  else if (kbits == 4)
    err = g ? launch_split4<true>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, aligned, vec, st)
            : launch_split4<false>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, aligned, vec, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(p, (u64*)mbuf, out_s, out_i, Q, n_splits, k, st);
}

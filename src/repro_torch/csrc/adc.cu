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
// matrix never written to device memory.  The TPU recasts the gather as a
// one-hot int8 MXU contraction; on Hopper the simple form is the gather
// itself out of shared memory:
//
//   pass 1 (adc_split_kernel): grid (ceil(Q/BQ), S), the layout of B2's
//     pass 1 (fused_topk.cu).  Block (qb, s) copies the int8 LUTs of its BQ
//     queries into shared memory once, laid out [subspace][query][codeword]
//     so that one code's entries for the block's queries sit K bytes apart
//     (a compile-time offset per query), then streams the s-th contiguous
//     range of code rows in tiles of BN=256 rows, staged in shared memory
//     (16-byte loads where rows allow).  A thread scores TR=4 rows for
//     TQ=BQ/4 queries in int32 registers: per code, one shared-memory
//     byte gather and one add per query.  B5 splits the nibbles in
//     registers: nibble t of a packed code word is subspace 8w+t, the low
//     nibble of a byte the even subspace (its row of lut_even), the high
//     one the odd subspace (lut_odd), as repro/kernels/ops.py:334-335
//     splits the LUT.
//     The candidate buffers, the threshold test on whole (score, ~id)
//     keys and the bitonic compaction are topk_common.cuh's, shared with
//     B2/B3: a tie at the threshold is decided by id and cannot flood a
//     buffer, which matters here because ADC scores are small integers
//     (|s| <= 128*M) and many rows share the k-th score.
//   pass 2: topk_common.cuh's merge, one block per query.
//
// The Python wrapper (kernels/adc.py `adc_layout`) is the one place that
// chooses the layout, so that any k <= N and any M launch: BQ 16, 8, 4, 2
// or 1 so that the BQ LUTs (M*K bytes each: 8 KB at M=32, K=256) plus the
// BQ candidate buffers (8*cap bytes each) fit in the 227 KB of shared
// memory; failing that, the buffers in a global scratch (GBUF); failing
// that (B4 past about M = 800), the LUTs read from global memory through
// L2 (LUTG, 4 queries a block).  Below 4 queries a block the 256 threads
// form BQ query groups of 256 / BQ row lanes, so a tile is 512 or 1024
// rows and an insert round ROW_LANES * 4 / BQ candidates a query; `cap`
// holds k plus one round.  At k <= 1024 and M <= 64 the layout, and the
// compiled shared-memory instances, are the first version's.
//
// Bound on the H100: operations for a full query bucket (Q*N*M int32
// adds; no gather or one-hot form does fewer), bytes for a single request
// (N*M code bytes at 3.35 TB/s).  This first version pays one
// shared-memory byte load per (query, row, subspace): with K=256 the 32
// lanes of a warp gather from one 256-byte LUT row, i.e. 64 words over 32
// banks, so random codes cost a few-way bank conflict; with K=16 (B5) a
// row is 4 words in 4 banks and the gathers are conflict-free.  A
// tensor-core one-hot form (the TPU's) or a register-resident LUT for
// K=16 is a later step.  Integer scores are exact; each is cast to f32
// (__int2float_rn) before its key is made, as the reference casts before
// its merge.  Allocates nothing: the wrapper passes the [Q, S, k]
// partial-key scratch and the outputs.

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

// the layouts kernels/adc.py adc_layout chooses: BQ 16, 8, 4, 2 or 1 with
// the LUTs in shared memory (buffers in shared or global memory), or BQ 4
// with the LUTs in global memory
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

}  // namespace

// kbits 8 (B4): lut0 = [Q, mb*256] int8 LUT, lut1 unused, codes [N, mb]
// uint8 codewords.  kbits 4 (B5): lut0 / lut1 = [Q, mb*16] int8 even / odd
// subspace LUT halves, codes [N, mb] uint8 packed nibbles (low = even
// subspace).  The caller chooses the pass-1 layout: bq queries per block,
// whether the LUTs are read from global memory (lutg), a candidate buffer
// of `cap` keys per query (a power of two holding k kept keys plus one
// round of NT / min(bq, 4) inserts), n_splits corpus ranges, and where the
// buffers live: `gbuf` null keeps them in shared memory, else gbuf holds
// [ceil(Q / bq) * n_splits, bq, cap] keys.  `part` holds Q * n_splits * k
// keys; `mbuf` null merges in shared memory, else it holds
// [Q, next_pow2(k + NT)] keys.  Launches pass 1 and pass 2 on `stream` and
// returns the first cudaError_t (0 on success).
extern "C" int rt_fused_adc(int kbits, int bq, int lutg, int cap,
                            const void* lut0, const void* lut1,
                            const void* codes, const void* mask, void* part,
                            void* gbuf, void* mbuf, void* out_s, void* out_i,
                            int Q, long long N, int mb, int k, int n_splits,
                            void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  if (bq <= 0 || cap != next_pow2(cap) || cap < k + NT / (bq < 4 ? bq : 4) ||
      n_splits <= 0 || mb <= 0 || ((uintptr_t)lut0 & 3) != 0 ||
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
  else if (kbits == 4)
    err = g ? launch_split_bq<4, true>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, aligned, vec, st)
            : launch_split_bq<4, false>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, aligned, vec, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(p, (u64*)mbuf, out_s, out_i, Q, n_splits, k, st);
}

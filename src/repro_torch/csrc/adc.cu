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
// matrix never written to device memory.  Three pass-1 kernels:
//
//   adc_word_kernel (B4 from 5 queries on): the packed-word gather (notes
//     at the kernel).  The LUTs of groups of 4 queries stay in shared
//     memory as biased bytes, one 32-bit word a (subspace, codeword)
//     holding the group's 4 entries, so one shared load serves 4 queries;
//     lane l takes subspace l ^ j at step j, so the warp's loads never
//     conflict; each word splits into two u16 x 2 words and one add sums
//     two queries.  64-row tiles come through B2 int8's producer warp and
//     mbarrier ring, and the lists are B2 int8's, per warp.
//   adc_split_kernel (B4 and B5 batches of at most 4 queries, B5's rows
//     too wide for adc4_mma_kernel): the first design's gather out of
//     shared memory.  Grid (ceil(Q/BQ), S), BQ = 1, 2 or 4.  Block (qb, s)
//     copies the int8 LUTs of its BQ queries into shared memory once, laid
//     out [subspace][query][codeword], then streams the s-th contiguous
//     range of code rows in tiles of 256 (BQ = 4), 512 or 1024 rows,
//     staged in shared memory under block barriers.  A thread scores TR=4
//     rows for its query in int32 registers: per code, one shared-memory
//     byte gather and one add.  B5 splits the nibbles in registers: nibble
//     t of a packed code word is subspace 8w+t, the low nibble of a byte
//     the even subspace (its row of lut_even), the high one the odd
//     subspace (lut_odd), as repro/kernels/ops.py:334-335 splits the LUT.
//     The candidate buffers, the threshold test on whole (score, ~id) keys
//     and the bitonic compaction are topk_common.cuh's: a tie at the
//     threshold is decided by id and cannot flood a buffer, which matters
//     here because ADC scores are small integers (|s| <= 128*M) and many
//     rows share the k-th score.
//   adc4_mma_kernel (B5 from 5 queries on): the TPU kernel's own one-hot
//     form on the int8 tensor cores (notes at the kernel).
//   pass 2: topk_common.cuh's merge, one block per query.
//
// The Python wrapper (kernels/adc.py `adc_layout`) is the one place that
// chooses the kernel and the layout, so that any k <= N and any M launch:
// the query tile, the warps a query group (word kernel), lists in shared
// memory or in a global scratch (GBUF), and LUTs in shared memory or read
// from global memory through L2 (LUTG: the word kernel past M = 192, the
// gather kernel past about M = 800 for B4 and 864 code bytes for B5).
//
// Bound on the H100: operations for a full query bucket (Q*N*M int32
// adds, the table's yardstick; B5's one-hot form does 2*Q*N*16M int8
// operations on the tensor cores instead, 1.09 ms at pq64x4, Q=256, N=4M),
// bytes for a single request (N*M code bytes at 3.35 TB/s).  What bounds
// the word kernel is its integer instructions: per (row, subspace, 4
// queries) a shared-memory word load and four integer-pipe instructions;
// its shared-memory bytes (3.28e10 at pq32, Q=256, N=4M) need 1.1 ms at
// 128 B a clock an SM.  The gather kernel pays one shared-memory byte load
// per (query, row, subspace), with a few-way bank conflict at K = 256
// (random codes over a 256-byte LUT row, 64 words over 32 banks) and none
// at K = 16.  Integer scores are exact; each is cast to f32
// (__int2float_rn) before its key is made, as the reference casts before
// its merge.  Allocates nothing: the wrapper passes the [Q, S * T, k]
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

// The gather kernel's layouts (kernels/adc.py adc_layout): batches of at
// most 4 queries at BQ 4, 2 or 1 with the LUTs in shared memory (buffers
// in shared or global memory), and BQ 4 with the LUTs in global memory (B4
// past about M = 800 at such batches; B5's rows too wide for its MMA
// kernel at any batch)
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
    case 4: return ADC_LAUNCH(4, false);
    case 2: return ADC_LAUNCH(2, false);
    case 1: return ADC_LAUNCH(1, false);
    default: return cudaErrorInvalidValue;
  }
#undef ADC_LAUNCH
}

// ---- B4: the packed-word gather ------------------------------------------

// A block is WN = NG * T consumer warps and one producer warp.  Each
// consumer warp owns G = 4 queries (one query group of the block's NG)
// and one candidate list per query, and scores every 64-row tile of
// subset t = warp / NG of the block's tiles (tiles t, t + T, ...), rows
// lane and lane + 32 a lane.  The block's LUTs stay in shared memory for
// the whole scan as biased bytes (u8 = lut + 128), query-innermost: for
// query group g, chunk ch of 32 subspaces, codeword c and subspace s of
// the chunk, one word holds the group's 4 queries' entries, at word
//   ((g * nch + ch) * 256 + c) * 32 + s.
// Lane l scores subspace s = l ^ j at step j of a chunk, so at every step
// the warp's 32 loads hit 32 distinct subspaces, i.e. 32 distinct banks,
// whatever the codes: no bank conflict.  A stage holds 32 code bytes (one
// chunk) of a tile's 64 rows, rows 32 bytes apart with no pad: lane l
// reads word J ^ (l >> 2) of its rows, again 32 distinct banks, and byte
// t ^ (l & 3) of it is the code of subspace l ^ (4 J + t).  What the step
// costs, as measured (PERF.md): the loads of a code word's four steps are
// issued before the previous code word's sums, so a warp keeps 8 loads in
// flight (the compiler left one load's latency on every second step); a
// step's address is one multiply-add on a per-lane offset table; the
// sums are multiply-adds by an opaque 1, so they run on the FMA pipe and
// leave the integer pipe to the code's byte move and the word's mask and
// byte move.  Tiles of 64 rows halve the ring's waits a row against 32
// (copies and waits alone 4.4 to 2.5 ms); tiles of 128 rows halved them
// again but ran slower whole.
constexpr int W_BM = 64;                  // rows a tile, two a lane
constexpr int WR = W_BM / 32;
constexpr int W_CW = 32;                  // subspaces (code bytes) a stage
constexpr int W_STAGES = 8;
constexpr int W_STAGE = W_BM * W_CW;
constexpr int W_MAXWARPS = 8;             // consumer warps a block at most
constexpr int W_CHUNK_WORDS = 256 * 32;  // LUT words of a chunk, a group

// shared memory of one block: the ring, the LUTs unless read from global
// memory, the ring's mbarriers, the lists unless they live in global
// memory (kernels/adc.py w_smem_bytes computes the same)
size_t w_smem_bytes(int ng, int warps, int cap, int mb, bool gbuf,
                    bool lutg) {
  const int nch = (mb + W_CW - 1) / W_CW;
  return (size_t)W_STAGES * W_STAGE +
         (lutg ? 0 : (size_t)ng * nch * W_CHUNK_WORDS * 4) +
         (size_t)2 * W_STAGES * 8 +
         (gbuf ? 0 : (size_t)warps * 4 * cap * 8);
}

// One biased LUT word (4 queries' u8 entries, q0 .. q0 + 3) of subspace
// `sub` and codeword c read from the int8 [Q, mb * 256] LUT in global
// memory (LUTG): zero past the last subspace; a query past Q reads query
// Q - 1's entries, whose scores are never offered.
__device__ __forceinline__ uint32_t lut_word_g(const int8_t* __restrict__ lut,
                                               int q0, int Q, int mb, int sub,
                                               uint32_t c) {
  if (sub >= mb) return 0u;
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long q = min(q0 + i, Q - 1);
    w |= (uint32_t)(uint8_t)__ldg(lut + (q * mb + sub) * 256 + c) << (8 * i);
  }
  return w ^ 0x80808080u;
}

// Pass 1 of B4 from 5 queries on: grid (ceil(Q / BQ), S), BQ = NG * G.
// The sum over subspaces is a gather from the resident LUT: each step a
// lane loads the word holding its G = 4 queries' biased entries
// for its row's code, splits it into two u16 x 2 words (bytes 0, 2 and
// bytes 1, 3: a mask and a prmt) and adds them, two queries an add.  A
// u16 lane holds at most 255 * 256 < 65536, so the lanes are flushed into
// int32 scores every 8 chunks (256 subspaces, of which pad subspaces add
// 0) and at the end, and 128 M comes off each score before its key is
// made (the bound test compares biased scores against the bound plus
// 128 M).  Integer sums are exact, so the order of subspaces is free.
// Copies come through B2 int8's producer warp and mbarrier ring
// (topk_common.cuh); the lists are B2 int8's per warp: each biased score
// tested in registers against its list's int bound, one vote a tile, the
// passing rows (masked) appended by a ballot in lane order, a list sorted
// down to k (warp_compact) only when the next tile could overflow it.  A
// list sees its warp's tiles in row order, so a row that ties the list's
// k-th score has the larger id and is rightly kept out by the int bound.
// At the end each warp sorts its lists and writes them to the partial
// scratch as parts split * T + t; pass 2 merges S * T lists a query.
// LUTG: the LUT words are read from global memory (4 bytes a word) for M
// too wide for one query group's LUTs in shared memory.
template <bool GBUF, bool LUTG>
__global__ void __launch_bounds__(32 * (W_MAXWARPS + 1), 2)
adc_word_kernel(const int8_t* __restrict__ lut,
                const uint8_t* __restrict__ codes,
                const int8_t* __restrict__ mask, u64* __restrict__ part,
                u64* __restrict__ gbuf, int Q, long long N, int mb, int k,
                int cap, int n_splits, int ng, int subsets, int c_mode) {
  constexpr int G = 4;
  constexpr unsigned FULL = 0xffffffffu;
  const int WN = ng * subsets;
  const int nch = (mb + W_CW - 1) / W_CW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lw = reinterpret_cast<uint32_t*>(smem + W_STAGES * W_STAGE);
  u64* full = reinterpret_cast<u64*>(
      lw + (LUTG ? 0 : (size_t)ng * nch * W_CHUNK_WORDS));
  u64* empty = full + W_STAGES;
  u64* lists = GBUF ? gbuf + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                 WN * G * cap
                    : empty + W_STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int q_block = blockIdx.x * ng * G;
  if (!LUTG) {
    // the block's LUTs, once: lane l takes subspace ch * 32 + l of a
    // 4-codeword block of 4 queries (four 4-byte loads), transposes the
    // 4 x 4 bytes and stores one word a codeword; zero past Q and mb
    for (int e = warp; e < ng * nch * 64; e += nwarps) {
      const int c4 = e & 63, r = e >> 6;
      const int ch = r % nch, g = r / nch;
      const int sub = ch * W_CW + lane;
      const int q0 = q_block + g * G;
      uint32_t y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = q0 + i < Q && sub < mb
                   ? __ldg(reinterpret_cast<const uint32_t*>(
                         lut + ((long long)(q0 + i) * mb + sub) * 256) + c4) ^
                         0x80808080u
                   : 0u;
      const uint32_t t0 = __byte_perm(y[0], y[1], 0x5140);
      const uint32_t t1 = __byte_perm(y[2], y[3], 0x5140);
      const uint32_t t2 = __byte_perm(y[0], y[1], 0x7362);
      const uint32_t t3 = __byte_perm(y[2], y[3], 0x7362);
      uint32_t* dst =
          lw + ((size_t)(g * nch + ch) * 256 + 4 * c4) * 32 + lane;
      dst[0] = __byte_perm(t0, t1, 0x5410);
      dst[32] = __byte_perm(t0, t1, 0x7632);
      dst[64] = __byte_perm(t2, t3, 0x5410);
      dst[96] = __byte_perm(t2, t3, 0x7632);
    }
  }
  if (tid == 0)
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], ng);
    }
  __syncthreads();

  // split y scans the tiles y, y + S, y + 2 S, ...; a step is one chunk
  // of one tile
  const long long n_tiles = (N + W_BM - 1) / W_BM;
  const long long my_tiles =
      n_tiles > blockIdx.y ? (n_tiles - 1 - blockIdx.y) / n_splits + 1 : 0;
  auto row_of = [&](long long i) {      // first row of the block's tile i
    return (i * n_splits + blockIdx.y) * W_BM;
  };
  const int8_t* cb = reinterpret_cast<const int8_t*>(codes);
  if (warp == WN) {
    long long s = 0;                    // step: one chunk of one tile
    for (long long i = 0; i < my_tiles; ++i)
      for (int ch = 0; ch < nch; ++ch, ++s) {
        const int slot = (int)(s % W_STAGES);
        if (s >= W_STAGES)
          mbar_wait(&empty[slot], (unsigned)((s / W_STAGES - 1) & 1));
        i8_stage<W_BM, 32, W_CW>(smem + slot * W_STAGE, W_CW, cb, row_of(i),
                                 N, mb, ch * W_CW, c_mode, lane);
        if (c_mode == 0)
          mbar_arrive(&full[slot]);
        else
          mbar_arrive_copies(&full[slot]);
      }
  }

  const int grp = warp % ng, sub_t = warp / ng;
  const int qg0 = q_block + grp * G;          // the warp's first query
  u64* my = lists + (size_t)warp * G * cap;   // [G, cap]
  // the shared address of the warp's query group's LUTs
  const uint32_t lg = smem_addr(lw + (size_t)grp * nch * W_CHUNK_WORDS);
  const long long bias = 128LL * mb;
  int cnt[G], T[G];
  u64 thr[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    cnt[q] = 0;
    thr[q] = 0ull;
    T[q] = qg0 + q < Q ? (int)0x80000000u : 0x7fffffff;
  }
  uint32_t sel[4];                // byte t ^ (l & 3) of a word, zeros above
#pragma unroll
  for (int t = 0; t < 4; ++t) sel[t] = 0x5540u | (uint32_t)(t ^ (lane & 3));
  // the shared address of step j's word for codeword 0 of chunk 0, so that
  // a step's address is one multiply-add: (code + 256 ch) * 128 + xo[j]
  uint32_t xo[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) xo[j] = lg + 4 * (lane ^ j);
  // 1, unknown to the compiler, so that the sums below stay multiply-adds
  // (the FMA pipe) and leave the integer pipe to the masks and byte moves
  const uint32_t one = mb > 0;
  const unsigned lt_mask = (1u << lane) - 1u;
  int sc[WR][G];
  for (long long i = sub_t; i < (warp < WN ? my_tiles : 0); i += subsets) {
    const long long t0 = row_of(i);
    for (int r = 0; r < WR; ++r)
      for (int q = 0; q < G; ++q) sc[r][q] = 0;
    uint32_t E[WR], O[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) E[r] = O[r] = 0u;
    for (int ch = 0; ch < nch; ++ch) {
      const long long st = i * nch + ch;
      const int slot = (int)(st % W_STAGES);
      mbar_wait(&full[slot], (unsigned)((st / W_STAGES) & 1));
      // this lane's rows, lane + 32 r of the tile
      const uint32_t* rows =
          reinterpret_cast<const uint32_t*>(smem + slot * W_STAGE) + lane * 8;
      const uint32_t chk = (uint32_t)ch;  // chunk, as byte 1 of the index
      // The LUT words of code word J's four steps (rows lane + 32 r);
      // each code word's loads are issued before the previous one's sums,
      // so a warp keeps 8 loads in flight
      auto load = [&](int J, uint32_t (&x)[4][WR]) {
        uint32_t cw[WR];
#pragma unroll
        for (int r = 0; r < WR; ++r) cw[r] = rows[r * 256 + (J ^ (lane >> 2))];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int r = 0; r < WR; ++r) {
            if constexpr (LUTG) {
              const int s = lane ^ (4 * J + t);   // this step's subspace
              const uint32_t c =
                  __byte_perm(cw[r], 0u, 0x4440u | (sel[t] & 3u));
              x[t][r] = lut_word_g(lut, qg0, Q, mb, ch * W_CW + s, c);
            } else {
              // code + 256 ch (ch < 8 here): the word's index in the group
              const uint32_t cc = __byte_perm(cw[r], chk, sel[t]);
              const uint32_t a = cc * 128 + xo[4 * J + t];
              asm("ld.shared.u32 %0, [%1];" : "=r"(x[t][r]) : "r"(a));
            }
          }
        }
      };
      // split each word into bytes 0, 2 and bytes 1, 3 as u16 x 2 and add
      auto add = [&](const uint32_t (&x)[4][WR]) {
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
      uint32_t xa[4][WR], xb[4][WR];
      load(0, xa);
#pragma unroll
      for (int J = 0; J < 8; J += 2) {
        load(J + 1, xb);
        add(xa);
        if (J + 2 < 8) load(J + 2, xa);
        add(xb);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if ((ch & 7) == 7 || ch == nch - 1) {
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          sc[r][0] += (int)(E[r] & 0xffffu);
          sc[r][1] += (int)(O[r] & 0xffffu);
          sc[r][2] += (int)(E[r] >> 16);
          sc[r][3] += (int)(O[r] >> 16);
          E[r] = O[r] = 0u;
        }
      }
    }

    // ---- epilogue of the tile at t0: the warp's own lists ----
    bool p[WR][G], any = false;
#pragma unroll
    for (int r = 0; r < WR; ++r)
#pragma unroll
      for (int q = 0; q < G; ++q) {
        p[r][q] = t0 + 32 * r + lane < N && sc[r][q] >= T[q];
        any |= p[r][q];
      }
    if (!__any_sync(FULL, any))  // no row of the tile passes
      continue;
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const long long row = t0 + 32 * r + lane;
      bool a = false;
#pragma unroll
      for (int q = 0; q < G; ++q) a |= p[r][q];
      if (a && mask != nullptr && mask[row] == 0)
#pragma unroll
        for (int q = 0; q < G; ++q) p[r][q] = false;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const unsigned b = __ballot_sync(FULL, p[r][q]);
        if (b == 0u) continue;
        if (p[r][q])
          my[(size_t)q * cap + cnt[q] + __popc(b & lt_mask)] =
              make_key(__int2float_rn((int)(sc[r][q] - bias)), row);
        cnt[q] += __popc(b);
        if (cnt[q] > cap - 32) {
          // a list the next 32 rows could overflow is sorted down to k
          int n = cnt[q];
          u64 th = thr[q];
          warp_compact(my + (size_t)q * cap, n, th, cap, k, lane);
          cnt[q] = n;
          thr[q] = th;
          const long long tb = (long long)int_bound(th) + bias;
          T[q] = (int)max(min(tb, 2147483647LL), -2147483648LL);
          __syncwarp();
        }
      }
    }
  }
  cp_async_wait<0>();

  // each list sorted down to its best k and written as part y * T + t
  if (warp < WN) {
    const int n_parts = n_splits * subsets;
    const int p_idx = blockIdx.y * subsets + sub_t;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (qg0 + q >= Q) break;
      u64* b = my + (size_t)q * cap;
      int n = cnt[q];
      u64 th = thr[q];
      if (n > 1) warp_compact(b, n, th, cap, k, lane);
      __syncwarp();
      u64* dst = part + ((size_t)(qg0 + q) * n_parts + p_idx) * k;
      for (int j = lane; j < k; j += 32) dst[j] = j < n ? b[j] : 0ull;
    }
  }
}

template <bool GBUF, bool LUTG>
cudaError_t launch_word(int ng, int subsets, const int8_t* lut,
                        const uint8_t* codes, const int8_t* mask, u64* part,
                        u64* gbuf, int Q, long long N, int mb, int k, int cap,
                        int n_splits, int c_mode, cudaStream_t stream) {
  const int warps = ng * subsets;
  const size_t smem = w_smem_bytes(ng, warps, cap, mb, GBUF, LUTG);
  auto fn = adc_word_kernel<GBUF, LUTG>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int bq = ng * 4;
  dim3 grid((Q + bq - 1) / bq, n_splits);
  fn<<<grid, 32 * (warps + 1), smem, stream>>>(lut, codes, mask, part, gbuf,
                                               Q, N, mb, k, cap, n_splits, ng,
                                               subsets, c_mode);
  return cudaGetLastError();
}

// resident blocks an SM of one B4 word-kernel launch, by the occupancy API
template <bool GBUF, bool LUTG>
int w_occupancy(int ng, int subsets, int cap, int mb) {
  const int warps = ng * subsets;
  const size_t smem = w_smem_bytes(ng, warps, cap, mb, GBUF, LUTG);
  auto fn = adc_word_kernel<GBUF, LUTG>;
  int per_sm = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                    32 * (warps + 1),
                                                    smem) != cudaSuccess)
    return -1;
  return per_sm;
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


// the word kernel's instances: lists in shared or global memory, LUTs in
// shared or global memory
cudaError_t launch_word_any(int ng, int subsets, bool gbuf_on, bool lutg,
                            const int8_t* lut, const uint8_t* codes,
                            const int8_t* mask, u64* part, u64* gbuf, int Q,
                            long long N, int mb, int k, int cap, int n_splits,
                            cudaStream_t st) {
  const int cm = i8_copy_mode(codes, mb);
#define W_LAUNCH(G_, L_)                                                    \
  launch_word<G_, L_>(ng, subsets, lut, codes, mask, part, gbuf, Q, N, mb, \
                      k, cap, n_splits, cm, st)
  if (gbuf_on) return lutg ? W_LAUNCH(true, true) : W_LAUNCH(true, false);
  return lutg ? W_LAUNCH(false, true) : W_LAUNCH(false, false);
#undef W_LAUNCH
}

int w_blocks(int ng, int subsets, int cap, bool gbuf, bool lutg, int mb) {
  if (gbuf) return lutg ? w_occupancy<true, true>(ng, subsets, cap, mb)
                        : w_occupancy<true, false>(ng, subsets, cap, mb);
  return lutg ? w_occupancy<false, true>(ng, subsets, cap, mb)
              : w_occupancy<false, false>(ng, subsets, cap, mb);
}

}  // namespace

// Resident B5 pass-1 blocks an SM at bq queries a block, lists of `cap`
// keys (in global memory when gbuf is nonzero) and code rows of mb bytes,
// as the occupancy API reports it; -1 on an error.  kernels/adc.py
// a4_blocks_per_sm must agree (tests/test_torch_gpu.py checks it).
extern "C" int rt_adc4_blocks_per_sm(int bq, int cap, int gbuf, int mb) {
  return a4_blocks(bq, cap, gbuf, mb);
}

// Resident B4 word-kernel blocks an SM at bq = 4 ng queries a block,
// `subsets` warps a query group, lists of `cap` keys (in global memory
// when gbuf is nonzero), LUTs in global memory when lutg is nonzero, and
// code rows of mb bytes, as the occupancy API reports it; -1 on an error.
// kernels/adc.py w_blocks_per_sm must agree (tests/test_torch_gpu.py
// checks it).
extern "C" int rt_adc_word_blocks_per_sm(int bq, int subsets, int cap,
                                         int gbuf, int lutg, int mb) {
  if (bq <= 0 || bq % 4 != 0 || subsets <= 0) return -1;
  return w_blocks(bq / 4, subsets, cap, gbuf != 0, lutg != 0, mb);
}

// kbits 8 (B4): lut0 = [Q, mb*256] int8 LUT, lut1 unused, codes [N, mb]
// uint8 codewords.  kbits 4 (B5): lut0 / lut1 = [Q, mb*16] int8 even / odd
// subspace LUT halves, codes [N, mb] uint8 packed nibbles (low = even
// subspace).  The caller chooses the pass-1 layout: bq queries a block,
// the kernel and where its LUTs live (`mode`: bit 0, the LUTs read from
// global memory; bit 1, B5 on adc_split_kernel, which batches of at most 4
// queries and rows too wide for its MMA kernel take; bit 2, B4 on
// adc_word_kernel, which batches from 5 queries on take, with `subsets`
// warps a query group; B4 without bit 2 runs adc_split_kernel at bq 4, 2
// or 1; B5 with mode 0 runs adc4_mma_kernel at bq 8, 16 or 32), a
// candidate list of `cap` keys a query (a power of two holding k kept keys
// plus one round of inserts: NT / min(bq, 4) rows for adc_split_kernel, a
// 32-row tile for the other two), n_splits corpus ranges, and where the
// lists live: `gbuf` null keeps them in shared memory, else gbuf holds
// [ceil(Q / bq) * n_splits, bq * subsets, cap] keys.  `part` holds Q *
// n_splits * subsets * k keys; `mbuf` null merges in shared memory, else
// it holds [Q, next_pow2(k + NT)] keys.  Launches pass 1 and pass 2 on
// `stream` and returns the first cudaError_t (0 on success).
extern "C" int rt_fused_adc(int kbits, int bq, int mode, int subsets, int cap,
                            const void* lut0, const void* lut1,
                            const void* codes, const void* mask, void* part,
                            void* gbuf, void* mbuf, void* out_s, void* out_i,
                            int Q, long long N, int mb, int k, int n_splits,
                            void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  const bool lutg = mode & 1;
  const bool word = kbits == 8 && (mode & 4);  // B4 on adc_word_kernel
  const bool mma = kbits == 4 && mode == 0;    // B5 on adc4_mma_kernel
  const int round = mma ? A4_BM : word ? 32 : NT / (bq < 4 ? bq : 4);
  if (bq <= 0 || cap != next_pow2(cap) || cap < k + round || n_splits <= 0 ||
      mb <= 0 || ((uintptr_t)lut0 & 3) != 0 ||
      (kbits == 4 && (lut1 == nullptr || ((uintptr_t)lut1 & 3) != 0)) ||
      (word && (bq % 4 != 0 || subsets <= 0 || bq / 4 * subsets > W_MAXWARPS ||
                (subsets - 1) * ((mb + W_CW - 1) / W_CW) + 1 > W_STAGES)) ||
      (!word && subsets != 1))
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
  if (word)
    err = launch_word_any(bq / 4, subsets, g != nullptr, lutg, l0, c, m, p,
                          g, Q, N, mb, k, cap, n_splits, st);
  else if (mma)
    err = launch_a4_bq(bq, l0, l1, c, m, p, g, Q, N, mb, k, cap, n_splits, st);
  else if (kbits == 8 || kbits == 4) {      // the gather kernel
#define SPLIT_LAUNCH(KB_, G_)                                                 \
  launch_split_bq<KB_, G_>(bq, lutg, l0, l1, c, m, p, g, Q, N, mb, k, cap,   \
                           n_splits, aligned, vec, st)
    err = kbits == 8 ? (g ? SPLIT_LAUNCH(8, true) : SPLIT_LAUNCH(8, false))
                     : (g ? SPLIT_LAUNCH(4, true) : SPLIT_LAUNCH(4, false));
#undef SPLIT_LAUNCH
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(p, (u64*)mbuf, out_s, out_i, Q, n_splits * subsets,
                           k, st);
}

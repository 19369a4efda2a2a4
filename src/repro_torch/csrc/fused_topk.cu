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
// 132 SMs, so the layout here is different:
//
//   pass 1 (split_topk_kernel): grid (ceil(Q/BQ), S).  Block (qb, s) scores
//     BQ queries against the s-th contiguous range of corpus rows, in tiles
//     of BN=256 rows and d-chunks of DK 32-bit words staged in shared
//     memory (16-byte loads, all in flight before the shared stores).  Each
//     thread holds a TQ x 4 (query x row) register tile, TQ = BQ / 4.
//     Per query the block keeps a candidate buffer of `cap` keys in shared
//     memory and a threshold (its current k-th best); a score enters the
//     buffer only if it beats the threshold, and a bitonic sort truncates
//     the buffer to k whenever it could overflow.  The Python wrapper
//     (kernels/fused_topk.py) is the one place that chooses the layout:
//     cap = next_pow2(2k + 64), BQ 16, 8 or 4 so that the buffers stay
//     within 64-128 KB, and S.  Block x is the query block, so the
//     blocks that read the same corpus range are resident together and
//     share it through L2.
//   pass 2 (merge_topk_kernel): one block per query merges the S partial
//     top-k lists the same way and writes ([Q, k] f32, [Q, k] i32).
//
// Order: (f32 score desc under the IEEE total order, row id asc), the
// reference's (`_merge_tile` takes the first position on ties; `lax.top_k`
// is stable).  The candidate buffers, their 64-bit (score, ~id) keys, the
// bitonic compaction and pass 2 live in topk_common.cuh, shared with the
// ADC scans (adc.cu).  Integer scores are cast to f32 before the key is
// made, as the reference casts before its merge (fused_topk.py:123): above
// 2^24, distinct int32 scores that round to one f32 become ties broken by
// id.
//
// Arithmetic: int8 and unpacked int4 dots are __dp4a with int32
// accumulation (exact); f32 dots are FFMA (no TF32); l2 is
// -(|q|^2 + |x|^2 - 2 q.x) in the accumulator type.  B3 unpacks nibbles in
// registers, (b & 0xF) - 8 and (b >> 4) - 8 via __vsub4 (Hopper has no int4
// MMA), and scores the pre-split even/odd query halves against the two
// nibble planes, as repro/kernels/ops.py:155 splits them.
//
// Bound on the H100: operations for large query batches (2*Q*N*d int8 ops
// at 1,979 TOP/s on the tensor cores, f32 at 67 TFLOP/s on the CUDA
// cores), bytes for a single request (N*d bytes at 3.35 TB/s).  This first
// version runs its dots on the CUDA cores (dp4a / FFMA) out of shared
// memory, so it stays well above the int8 bound; mma.sync / wgmma int8
// with TMA-fed tiles is the later step.  Allocates nothing: the wrapper
// passes the [Q, S, k] partial-key scratch and the outputs.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "topk_common.cuh"

namespace {

// NT (256 threads) and ROW_LANES (64 threads sharing one query group) come
// from topk_common.cuh
constexpr int TR = 4;                   // corpus rows per thread per tile
constexpr int BN = ROW_LANES * TR;      // 256 corpus rows per tile
constexpr int DK = 32;                  // 32-bit words per d-chunk
constexpr int XS_STRIDE = DK + 1;       // odd stride: conflict-free rows

enum Kind { KIND_F32 = 0, KIND_I8 = 1, KIND_I4 = 2 };

// word w (4 int8 values, little-endian) of an int8 row of `width` bytes,
// zero past the end of the row
__device__ __forceinline__ uint32_t load_i8_word(const int8_t* row, int width,
                                                 int w, bool aligned) {
  if (aligned) return reinterpret_cast<const uint32_t*>(row)[w];
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int idx = 4 * w + b;
    if (idx < width) v |= (uint32_t)(uint8_t)row[idx] << (8 * b);
  }
  return v;
}

// word w of a packed-int4 row of h bytes seen as two planes of wh words:
// [0, wh) the low (even-dim) nibbles, [wh, 2 wh) the high (odd-dim) ones,
// each unpacked to signed bytes (nibble - 8); bytes past h are 0
__device__ __forceinline__ uint32_t load_i4_word(const uint8_t* row, int h,
                                                 int wh, int w, bool aligned) {
  const int plane = w >= wh;
  const int pw = plane ? w - wh : w;
  const int nvalid = min(4, h - 4 * pw);
  uint32_t raw;
  if (aligned) {
    raw = reinterpret_cast<const uint32_t*>(row)[pw];
  } else {
    raw = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (b < nvalid) raw |= (uint32_t)row[4 * pw + b] << (8 * b);
  }
  const uint32_t nib = plane ? ((raw >> 4) & 0x0F0F0F0Fu) : (raw & 0x0F0F0F0Fu);
  uint32_t v = __vsub4(nib, 0x08080808u);
  if (nvalid < 4) v &= (1u << (8 * nvalid)) - 1u;
  return v;
}

template <int KIND>
struct Rows {
  // corpus word w of row r
  __device__ __forceinline__ static uint32_t x_word(const void* x, long long r,
                                                    int width, int wh, int w,
                                                    bool aligned) {
    if (KIND == KIND_F32) {
      return __float_as_uint(static_cast<const float*>(x)[r * width + w]);
    } else if (KIND == KIND_I8) {
      return load_i8_word(static_cast<const int8_t*>(x) + r * width, width, w,
                          aligned);
    } else {
      return load_i4_word(static_cast<const uint8_t*>(x) + r * width, width,
                          wh, w, aligned);
    }
  }
  // query word w of query q (B3: q0 = even half, q1 = odd half)
  __device__ __forceinline__ static uint32_t q_word(const void* q0,
                                                    const void* q1, int q,
                                                    int width, int wh, int w,
                                                    bool aligned) {
    if (KIND == KIND_F32) {
      return __float_as_uint(static_cast<const float*>(q0)[(long long)q * width + w]);
    } else if (KIND == KIND_I8) {
      return load_i8_word(static_cast<const int8_t*>(q0) + (long long)q * width,
                          width, w, aligned);
    } else {
      const int plane = w >= wh;
      const int8_t* src = static_cast<const int8_t*>(plane ? q1 : q0);
      return load_i8_word(src + (long long)q * width, width, plane ? w - wh : w,
                          aligned);
    }
  }
};

// words w..w+3 of corpus row r as one 16-byte load (the `x_vec` layout:
// rows 16-byte aligned, so no 4-word group straddles a row end or, for
// B3, a nibble plane); B3 unpacks the 16 raw bytes into 4 plane words
template <int KIND>
__device__ __forceinline__ uint4 x_vec4(const void* x, long long r, int W,
                                        int wh, int w) {
  if (KIND != KIND_I4) {
    return *reinterpret_cast<const uint4*>(
        static_cast<const uint32_t*>(x) + r * W + w);
  }
  const int plane = w >= wh;
  uint4 v = *reinterpret_cast<const uint4*>(
      static_cast<const uint32_t*>(x) + r * wh + (plane ? w - wh : w));
  const int shift = plane ? 4 : 0;
  v.x = __vsub4((v.x >> shift) & 0x0F0F0F0Fu, 0x08080808u);
  v.y = __vsub4((v.y >> shift) & 0x0F0F0F0Fu, 0x08080808u);
  v.z = __vsub4((v.z >> shift) & 0x0F0F0F0Fu, 0x08080808u);
  v.w = __vsub4((v.w >> shift) & 0x0F0F0F0Fu, 0x08080808u);
  return v;
}

template <int KIND>
using AccT = typename std::conditional<KIND == KIND_F32, float, int>::type;

__device__ __forceinline__ float dot_word(uint32_t a, uint32_t b, float acc) {
  return fmaf(__uint_as_float(a), __uint_as_float(b), acc);
}
__device__ __forceinline__ int dot_word(uint32_t a, uint32_t b, int acc) {
  return __dp4a((int)a, (int)b, acc);
}

__device__ __forceinline__ float finish(float dot, float qn, float xn, bool l2) {
  if (!l2) return dot;
  return -__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.0f, dot));
}
__device__ __forceinline__ float finish(int dot, int qn, int xn, bool l2) {
  if (!l2) return __int2float_rn(dot);
  return __int2float_rn(-(qn + xn - 2 * dot));
}

size_t split_smem_bytes(int bq, int cap) {
  return (size_t)bq * cap * 8 + (size_t)bq * 8 + (size_t)BN * XS_STRIDE * 4 +
         (size_t)bq * DK * 4 + (size_t)BN * 4 + (size_t)bq * 4 * 3;
}

// At most 128 registers a thread, so that two blocks fit on an SM: the
// layout's shared memory (about 100 KB a block up to k = 400) allows two.
// Left free, nvcc gave the packed-int4 ip variant at BQ = 8 (k = 400) 169
// registers, one block per SM, and 1.4x the time.
template <int KIND, bool L2, int BQ>
__global__ void __launch_bounds__(NT, 2)
split_topk_kernel(const void* __restrict__ q0, const void* __restrict__ q1,
                  const void* __restrict__ x, const int8_t* __restrict__ mask,
                  u64* __restrict__ part, int Q, long long N, int width,
                  int k, int cap, int n_splits, long long rows_per_split,
                  bool x_aligned, bool q_aligned, bool x_vec) {
  using Acc = AccT<KIND>;
  constexpr int TQ = BQ / 4;            // queries per thread (4 query groups)
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);                  // [BQ, cap]
  u64* thresh = buf + (size_t)BQ * cap;                     // [BQ]
  uint32_t* xs = reinterpret_cast<uint32_t*>(thresh + BQ);  // [BN, XS_STRIDE]
  uint32_t* qs = xs + BN * XS_STRIDE;                       // [BQ, DK]
  Acc* xn = reinterpret_cast<Acc*>(qs + BQ * DK);           // [BN]
  Acc* qn = xn + BN;                                        // [BQ]
  int* cnt = reinterpret_cast<int*>(qn + BQ);               // [BQ]
  int* need = cnt + BQ;                                     // [BQ]

  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);
  const int wh = (width + 3) / 4;
  const int W = KIND == KIND_F32 ? width : (KIND == KIND_I8 ? wh : 2 * wh);

  if (tid < BQ) {
    cnt[tid] = 0;
    thresh[tid] = 0ull;
    Acc s = 0;
    const int q = q_base + tid;
    if (L2 && q < Q) {
      for (int w = 0; w < W; ++w) {
        const uint32_t v = Rows<KIND>::q_word(q0, q1, q, width, wh, w, q_aligned);
        s = dot_word(v, v, s);
      }
    }
    qn[tid] = s;
  }

  const int qg = tid / ROW_LANES;
  const int lane = tid % ROW_LANES;

  for (long long t0 = r_begin; t0 < r_end; t0 += BN) {
    Acc acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0;
    Acc xsq = 0;                        // |x|^2 of tile row `tid`

    for (int c0 = 0; c0 < W; c0 += DK) {
      __syncthreads();
      if (x_vec) {
        // every 16-byte load of the chunk in flight before the first
        // shared store: the load latency is paid once per chunk
        constexpr int VPR = DK / 4;            // uint4 per row per chunk
        constexpr int VPT = BN * VPR / NT;     // uint4 per thread
        uint4 v[VPT];
#pragma unroll
        for (int it = 0; it < VPT; ++it) {
          const int e = tid + it * NT, r = e / VPR, w = c0 + 4 * (e % VPR);
          v[it] = make_uint4(0u, 0u, 0u, 0u);
          if (t0 + r < r_end && w < W) v[it] = x_vec4<KIND>(x, t0 + r, W, wh, w);
        }
#pragma unroll
        for (int it = 0; it < VPT; ++it) {
          const int e = tid + it * NT;
          uint32_t* dst = xs + (e / VPR) * XS_STRIDE + 4 * (e % VPR);
          dst[0] = v[it].x;
          dst[1] = v[it].y;
          dst[2] = v[it].z;
          dst[3] = v[it].w;
        }
      } else {
        for (int e = tid; e < BN * DK; e += NT) {
          const int r = e / DK, w = e % DK;
          const long long row = t0 + r;
          uint32_t v = 0;
          if (row < r_end && c0 + w < W)
            v = Rows<KIND>::x_word(x, row, width, wh, c0 + w, x_aligned);
          xs[r * XS_STRIDE + w] = v;
        }
      }
      for (int e = tid; e < BQ * DK; e += NT) {
        const int qi = e / DK, w = e % DK;
        const int q = q_base + qi;
        uint32_t v = 0;
        if (q < Q && c0 + w < W)
          v = Rows<KIND>::q_word(q0, q1, q, width, wh, c0 + w, q_aligned);
        qs[qi * DK + w] = v;
      }
      __syncthreads();
      if (L2) {
#pragma unroll 8
        for (int w = 0; w < DK; ++w) {
          const uint32_t v = xs[tid * XS_STRIDE + w];
          xsq = dot_word(v, v, xsq);
        }
      }
#pragma unroll 4
      for (int w = 0; w < DK; ++w) {
        uint32_t qv[TQ], xv[TR];
#pragma unroll
        for (int i = 0; i < TQ; ++i) qv[i] = qs[(qg * TQ + i) * DK + w];
#pragma unroll
        for (int j = 0; j < TR; ++j) xv[j] = xs[(lane + j * ROW_LANES) * XS_STRIDE + w];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j) acc[i][j] = dot_word(qv[i], xv[j], acc[i][j]);
      }
    }
    xn[tid] = xsq;
    __syncthreads();

    // insert in TR rounds: at most ROW_LANES candidates per query per
    // round, and cap >= k + ROW_LANES, so a buffer compacted to k between
    // rounds never overflows
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int r = lane + j * ROW_LANES;
      const long long row = t0 + r;
      const bool ok_row = row < r_end && (mask == nullptr || mask[row] != 0);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = qg * TQ + i;
        if (ok_row && q_base + qi < Q)
          offer(buf, thresh, cnt, qi, cap,
                make_key(finish(acc[i][j], qn[qi], xn[r], L2), row));
      }
      compact(buf, thresh, cnt, need, BQ, cap, k, cap - ROW_LANES);
    }
  }

  flush_partial(buf, thresh, cnt, need, BQ, cap, k, part, q_base, Q, split,
                n_splits);
}

template <int KIND, bool L2, int BQ>
cudaError_t launch_split(const void* q0, const void* q1, const void* x,
                         const int8_t* mask, u64* part, int Q, long long N,
                         int width, int k, int cap, int n_splits,
                         bool x_aligned, bool q_aligned, bool x_vec,
                         cudaStream_t stream) {
  const size_t smem = split_smem_bytes(BQ, cap);
  auto fn = split_topk_kernel<KIND, L2, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows_per_split = (N + n_splits - 1) / n_splits;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  fn<<<grid, NT, smem, stream>>>(q0, q1, x, mask, part, Q, N, width, k, cap,
                                 n_splits, rows_per_split, x_aligned,
                                 q_aligned, x_vec);
  return cudaGetLastError();
}

template <int KIND, bool L2>
cudaError_t launch_split_bq(int bq, const void* q0, const void* q1,
                            const void* x, const int8_t* mask, u64* part,
                            int Q, long long N, int width, int k, int cap,
                            int n_splits, bool xa, bool qa, bool xv,
                            cudaStream_t st) {
  if (bq == 16)
    return launch_split<KIND, L2, 16>(q0, q1, x, mask, part, Q, N, width, k,
                                      cap, n_splits, xa, qa, xv, st);
  if (bq == 8)
    return launch_split<KIND, L2, 8>(q0, q1, x, mask, part, Q, N, width, k,
                                     cap, n_splits, xa, qa, xv, st);
  if (bq == 4)
    return launch_split<KIND, L2, 4>(q0, q1, x, mask, part, Q, N, width, k,
                                     cap, n_splits, xa, qa, xv, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 f32, 1 int8, 2 packed int4 (q0/q1 = even/odd query halves,
// width = bytes per packed row).  The caller chooses the pass-1 layout:
// bq queries per block, a candidate buffer of `cap` keys per query (a power
// of two holding k kept keys plus one round of ROW_LANES inserts) and
// n_splits corpus ranges; `part` holds Q * n_splits * k keys.  Launches
// pass 1 and pass 2 on `stream` and returns the first cudaError_t (0 on
// success).
extern "C" int rt_fused_topk(int kind, int l2, int bq, int cap,
                             const void* q0, const void* q1, const void* x,
                             const void* mask, void* part, void* out_s,
                             void* out_i, int Q, long long N, int width,
                             int k, int n_splits, void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  if (cap != next_pow2(cap) || cap < k + ROW_LANES || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool x_aligned =
      kind == KIND_F32 || (width % 4 == 0 && ((uintptr_t)x & 3) == 0);
  const bool q_aligned =
      kind == KIND_F32 || (width % 4 == 0 && ((uintptr_t)q0 & 3) == 0 &&
                           (q1 == nullptr || ((uintptr_t)q1 & 3) == 0));
  // 16-byte corpus loads: 16-byte aligned rows (f32: d % 4 == 0; int8 and
  // packed int4: bytes per row % 16 == 0)
  const bool x_vec = ((uintptr_t)x & 15) == 0 &&
                     (kind == KIND_F32 ? width % 4 == 0 : width % 16 == 0);
  const int8_t* m = (const int8_t*)mask;
  u64* p = (u64*)part;
  cudaError_t err;
  if (kind == KIND_F32)
    err = l2 ? launch_split_bq<KIND_F32, true>(bq, q0, q1, x, m, p, Q, N, width, k, cap, n_splits, x_aligned, q_aligned, x_vec, st)
             : launch_split_bq<KIND_F32, false>(bq, q0, q1, x, m, p, Q, N, width, k, cap, n_splits, x_aligned, q_aligned, x_vec, st);
  else if (kind == KIND_I8)
    err = l2 ? launch_split_bq<KIND_I8, true>(bq, q0, q1, x, m, p, Q, N, width, k, cap, n_splits, x_aligned, q_aligned, x_vec, st)
             : launch_split_bq<KIND_I8, false>(bq, q0, q1, x, m, p, Q, N, width, k, cap, n_splits, x_aligned, q_aligned, x_vec, st);
  else if (kind == KIND_I4)
    err = l2 ? launch_split_bq<KIND_I4, true>(bq, q0, q1, x, m, p, Q, N, width, k, cap, n_splits, x_aligned, q_aligned, x_vec, st)
             : launch_split_bq<KIND_I4, false>(bq, q0, q1, x, m, p, Q, N, width, k, cap, n_splits, x_aligned, q_aligned, x_vec, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(p, out_s, out_i, Q, n_splits, k, st);
}

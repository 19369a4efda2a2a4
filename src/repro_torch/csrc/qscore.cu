// B6, B7 and B8: int32 [Q, N] score matrices over integer codes.
//
// Replaces the TPU kernels
//   B6  repro/kernels/qmip.py   `qmip_pallas`  (`_qmip_kernel`): q . x
//   B7  repro/kernels/ql2.py    `ql2_pallas`   (`_ql2_kernel`):
//       -(|q|^2 + |x|^2 - 2 q . x), norms recomputed per tile
//   B8  repro/kernels/packed.py `qmip4_pallas` / `ql24_pallas`
//       (`_packed_call`, tiles `qmip4_tile` / `ql24_tile`): B6 / B7 over a
//       packed-int4 corpus, q_even . lo + q_odd . hi
// What carries over is what they compute: every (query, corpus row) pair
// scored exactly in int32 and the whole [Q, N] matrix written out.  The TPU
// kernels take (bq, bn) tiles padded to multiples by the wrapper; here the
// kernel masks ragged Q, N and d itself, so nothing is padded in device
// memory.
//
// Layout: grid (ceil(Q / BQ), corpus tiles).  Block (qb, t) owns an output
// tile of BQ queries x BN = 512 corpus rows; thread i owns columns i and
// i + 256 of it for all BQ queries (a BQ x 2 int32 register tile), so the
// output stores of a warp are 32 consecutive int32 (coalesced, streamed
// past L2 with st.global.cs).  Block x is the query block, so the
// ceil(Q / BQ) blocks that read one corpus tile run together and share it
// through L2.  The corpus tile is staged in shared memory in d-chunks of 64
// bytes with 16-byte loads (all in flight before the shared stores), rows
// at a stride of 20 words: a quarter-warp's 16-byte reads of eight rows
// then hit 32 distinct banks.  The query chunk sits beside it and every
// thread reads the same query word (a broadcast).  A d that is not a
// multiple of 4 (or a chunk past the row) is padded in shared memory only:
// with 0 for int8 codes and with 0x88 for packed bytes, whose two nibbles
// unpack to 8 - 8 = 0, so the pad adds nothing to a dot or a norm.
//
// Arithmetic: __dp4a with int32 accumulation (exact: |q . x| <= 128^2 d).
// B7/B8b sum |q|^2 (one thread per query) and |x|^2 (per row, beside the
// dots) from the staged chunks, then combine in uint32 so the result wraps
// as the reference's int32 arithmetic does.  B8 unpacks nibbles in registers,
// (b & 0xF) - 8 and (b >> 4) - 8 via __vsub4, the low one against the even
// query half, the high one against the odd (repro/kernels/ops.py:155).
//
// Bound on the H100: bytes.  The [Q, N] int32 output dominates from a few
// queries on (Q = 512, N = 1M: 2.05 GB, 0.61 ms at 3.35 TB/s); a single
// query streams the codes (N = 1M, d = 128: 128 MB, 0.038 ms).  The int8
// operations (2 Q N d) need 0.066 ms on the tensor cores at Q = 512; here
// they run as dp4a on the CUDA cores, which is the later speed step
// (mma.sync / wgmma int8), together with double-buffered tiles.  The
// Python wrapper picks BQ from Q (1 ... 16), so a single query does not
// compute 15 empty rows.  BQ stops at 16, whose tile fits 128 registers
// (two blocks an SM): a 32-query tile needs twice the accumulators, nvcc
// gave it twice the registers, and it ran slower on the H100.  Allocates nothing: the wrapper passes the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int TR = 2;              // corpus columns per thread
constexpr int BN = NT * TR;        // 512 corpus rows per tile
constexpr int CW = 16;             // 32-bit words per d-chunk (64 bytes)
constexpr int CB = CW * 4;         // bytes per d-chunk
constexpr int SEG = CW / 4;        // 16-byte segments per chunk row
constexpr int XS = CW + 4;         // shared row stride in words (XS/4 odd)

// a 16-byte group of row `row`'s bytes [b, b + 16) of a `width`-byte row,
// `pad` past the end of the row (or for a row past the last)
__device__ __forceinline__ uint4 load_seg(const uint8_t* __restrict__ base,
                                          long long row, long long n_rows,
                                          int width, int b, bool vec,
                                          uint32_t pad) {
  if (row >= n_rows || b >= width) return make_uint4(pad, pad, pad, pad);
  const uint8_t* p = base + row * width + b;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int idx = 4 * j + t;
      const uint32_t byte = b + idx < width ? (uint32_t)__ldg(p + idx)
                                            : (pad & 0xFFu);
      v |= byte << (8 * t);
    }
    w[j] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// packed-int4 word -> (even-dim, odd-dim) signed nibble words
__device__ __forceinline__ void unpack4(uint32_t raw, int& lo, int& hi) {
  lo = (int)__vsub4(raw & 0x0F0F0F0Fu, 0x08080808u);
  hi = (int)__vsub4((raw >> 4) & 0x0F0F0F0Fu, 0x08080808u);
}

// I4: x holds packed bytes (width = d/2 per row), q0 / q1 the even / odd
// query halves (width bytes each); else x and q0 are int8 rows of width = d.
template <int BQ, bool I4, bool L2>
__global__ void __launch_bounds__(NT)
qscore_kernel(const int8_t* __restrict__ q0, const int8_t* __restrict__ q1,
              const uint8_t* __restrict__ x, int32_t* __restrict__ out,
              int Q, long long N, int width, long long n_tiles, bool x_vec,
              bool q_vec) {
  constexpr int P = I4 ? 2 : 1;                 // query planes
  constexpr uint32_t XPAD = I4 ? 0x88888888u : 0u;
  __shared__ __align__(16) uint32_t xs[BN * XS];
  __shared__ __align__(16) uint32_t qs[P * BQ * CW];
  __shared__ int qq_s[BQ];

  const int tid = threadIdx.x;
  const int qbase = blockIdx.x * BQ;
  const int n_chunks = (width + CB - 1) / CB;

  for (long long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const long long n0 = tile * BN;
    int acc[BQ][TR];
    int xx[TR];
#pragma unroll
    for (int q = 0; q < BQ; ++q)
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[q][r] = 0;
#pragma unroll
    for (int r = 0; r < TR; ++r) xx[r] = 0;
    int qq = 0;                        // |q|^2 of query `tid` (tid < BQ)

    for (int c = 0; c < n_chunks; ++c) {
      const int cb = c * CB;
      __syncthreads();                 // the previous chunk has been read
      // corpus chunk: BN rows x SEG segments, all loads before the stores
      uint4 v[BN * SEG / NT];
#pragma unroll
      for (int j = 0; j < BN * SEG / NT; ++j) {
        const int i = tid + j * NT;
        v[j] = load_seg(x, n0 + i / SEG, N, width, cb + (i % SEG) * 16, x_vec,
                        XPAD);
      }
#pragma unroll
      for (int j = 0; j < BN * SEG / NT; ++j) {
        const int i = tid + j * NT;
        *reinterpret_cast<uint4*>(&xs[(i / SEG) * XS + (i % SEG) * 4]) = v[j];
      }
      // query chunk: P planes x BQ rows x SEG segments (0 past Q and width)
      for (int i = tid; i < P * BQ * SEG; i += NT) {
        const int p = i / (BQ * SEG);
        const int rq = (i / SEG) % BQ;
        const uint4 w = load_seg(reinterpret_cast<const uint8_t*>(p ? q1 : q0),
                                 qbase + rq, Q, width, cb + (i % SEG) * 16,
                                 q_vec, 0u);
        *reinterpret_cast<uint4*>(&qs[(p * BQ + rq) * CW + (i % SEG) * 4]) = w;
      }
      __syncthreads();
      if (L2 && tid < BQ) {
#pragma unroll
        for (int w = 0; w < P * CW; ++w) {
          const int v = (int)qs[((w / CW) * BQ + tid) * CW + w % CW];
          qq = __dp4a(v, v, qq);
        }
      }

#pragma unroll
      for (int s = 0; s < SEG; ++s) {
        // this thread's TR rows: 4 words each (unpacked to 8 for int4)
        int xa[TR][4], xb[TR][4];
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              &xs[(tid + r * NT) * XS + s * 4]);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (I4) {
              unpack4(ws[j], xa[r][j], xb[r][j]);
              if (L2) {
                xx[r] = __dp4a(xa[r][j], xa[r][j], xx[r]);
                xx[r] = __dp4a(xb[r][j], xb[r][j], xx[r]);
              }
            } else {
              xa[r][j] = (int)ws[j];
              xb[r][j] = 0;
              if (L2) xx[r] = __dp4a(xa[r][j], xa[r][j], xx[r]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < BQ; ++q) {
          const uint4 qa = *reinterpret_cast<const uint4*>(&qs[q * CW + s * 4]);
          const int qa4[4] = {(int)qa.x, (int)qa.y, (int)qa.z, (int)qa.w};
          int qb4[4] = {0, 0, 0, 0};
          if (I4) {
            const uint4 qb = *reinterpret_cast<const uint4*>(
                &qs[(BQ + q) * CW + s * 4]);
            qb4[0] = (int)qb.x; qb4[1] = (int)qb.y;
            qb4[2] = (int)qb.z; qb4[3] = (int)qb.w;
          }
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[q][r] = __dp4a(qa4[j], xa[r][j], acc[q][r]);
              if (I4) acc[q][r] = __dp4a(qb4[j], xb[r][j], acc[q][r]);
            }
        }
      }
    }

    if (L2) {
      if (tid < BQ) qq_s[tid] = qq;
      __syncthreads();
    }
    // epilogue: int32 scores (B7/B8b: -(qq + xx - 2 dot), wrapping as int32)
#pragma unroll
    for (int q = 0; q < BQ; ++q) {
      const int qi = qbase + q;
      if (qi >= Q) break;
      int32_t* orow = out + (long long)qi * N;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const long long n = n0 + tid + r * NT;
        if (n >= N) continue;
        int val = acc[q][r];
        if (L2) {
          const uint32_t t = (uint32_t)qq_s[q] + (uint32_t)xx[r] -
                             2u * (uint32_t)acc[q][r];
          val = (int)(0u - t);
        }
        __stcs(orow + n, val);
      }
    }
  }
}

template <int BQ, bool I4, bool L2>
cudaError_t launch(const void* q0, const void* q1, const void* x, void* out,
                   int Q, long long N, int width, bool x_vec, bool q_vec,
                   cudaStream_t stream) {
  const long long n_tiles = (N + BN - 1) / BN;
  dim3 grid((Q + BQ - 1) / BQ,
            (unsigned)(n_tiles < 65535 ? n_tiles : 65535));
  qscore_kernel<BQ, I4, L2><<<grid, NT, 0, stream>>>(
      (const int8_t*)q0, (const int8_t*)q1, (const uint8_t*)x,
      (int32_t*)out, Q, N, width, n_tiles, x_vec, q_vec);
  return cudaGetLastError();
}

template <bool I4, bool L2>
cudaError_t launch_bq(int bq, const void* q0, const void* q1, const void* x,
                      void* out, int Q, long long N, int width, bool x_vec,
                      bool q_vec, cudaStream_t st) {
  switch (bq) {
    case 1: return launch<1, I4, L2>(q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
    case 2: return launch<2, I4, L2>(q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
    case 4: return launch<4, I4, L2>(q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
    case 8: return launch<8, I4, L2>(q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
    case 16: return launch<16, I4, L2>(q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// i4: 0 for int8 rows (q0 [Q, width], x [N, width] int8), 1 for packed int4
// (q0 / q1 the even / odd query halves [Q, width] int8, x [N, width] uint8
// packed bytes); l2: 0 inner product, 1 negated squared L2; bq: queries per
// block (1, 2, 4, 8 or 16, chosen by the caller).  Writes out [Q, N]
// int32 on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int rt_qscore(int i4, int l2, int bq, const void* q0,
                         const void* q1, const void* x, void* out, int Q,
                         long long N, int width, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (width <= 0 || (i4 && q1 == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte loads need 16-byte aligned rows
  const bool x_vec = ((uintptr_t)x & 15) == 0 && width % 16 == 0;
  const bool q_vec = ((uintptr_t)q0 & 15) == 0 && width % 16 == 0 &&
                     (q1 == nullptr || ((uintptr_t)q1 & 15) == 0);
  cudaError_t err;
  if (i4)
    err = l2 ? launch_bq<true, true>(bq, q0, q1, x, out, Q, N, width, x_vec, q_vec, st)
             : launch_bq<true, false>(bq, q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
  else
    err = l2 ? launch_bq<false, true>(bq, q0, q1, x, out, Q, N, width, x_vec, q_vec, st)
             : launch_bq<false, false>(bq, q0, q1, x, out, Q, N, width, x_vec, q_vec, st);
  return (int)err;
}

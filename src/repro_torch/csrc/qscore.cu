// B6, B7 and B8: int32 [Q, N] score matrices over integer codes.
//
// Replaces the TPU kernels
//   B6  repro/kernels/qmip.py   `qmip_pallas`  (`_qmip_kernel`): q . x
//   B7  repro/kernels/ql2.py    `ql2_pallas`   (`_ql2_kernel`):
//       -(|q|^2 + |x|^2 - 2 q . x), norms recomputed per tile
//   B8  repro/kernels/packed.py `qmip4_pallas` (B8a) / `ql24_pallas` (B8b)
//       (`_packed_call`, tiles `qmip4_tile` / `ql24_tile`): B6 / B7 over a
//       packed-int4 corpus, q_even . lo + q_odd . hi
// What carries over is what they compute: every (query, corpus row) pair
// scored exactly in int32 and the whole [Q, N] matrix written out.  The TPU
// kernels take (bq, bn) tiles padded to multiples by the wrapper; here the
// kernel masks ragged Q, N and d itself, so nothing is padded in device
// memory.  It does not allocate: the wrapper passes the output.
//
// Bound on the H100: bytes.  The [Q, N] int32 output dominates from a few
// queries on (Q = 512, N = 1M: 2.05 GB, 0.61 ms at 3.35 TB/s); a single
// query streams the codes (N = 1M, d = 128: 128 MB, 0.038 ms).  The
// operations (2 Q N d = 1.3e11 at Q = 512) need 0.066 ms on the int8
// tensor cores, a tenth of the byte bound, so a kernel at the bound must
// keep the output stream busy all the time and hide the dots under it.
//
// All four: `qmip_mma_kernel`, on the int8 tensor cores (`L2` selects B7 /
// B8b's negated squared L2; B6 / B8a are its `L2 = false` instances).
//   * mma.sync m16n8k32 s8 x s8 -> s32, corpus rows in M and queries in N:
//     both operands are stored K-contiguous ([N, w] and [Q, w] bytes) as
//     `.row.col` wants, and ldmatrix fills the fragments from shared memory.
//     s32 accumulation is exact (|q . x| <= 128^2 d).  An output tile is BM
//     corpus rows x QT queries; QT follows Q (8 ... 128, chosen by the
//     wrapper), so a single query wastes 7/8 of a cheap MMA, no more.
//     Eight warps, each 32 corpus rows x QT / WARPS_N queries.
//   * B8a / B8b: ldmatrix loads packed bytes where the int8 kernel loads
//     codes: a 32-bit word holds four consecutive bytes of one row, i.e. K
//     positions j..j+3 of both nibble planes.  __vsub4 unpacks it in
//     registers into the lo word (against the even query half) and the hi
//     word (against the odd half): two s8 MMAs per packed K-step.
//   * Staging: a ring of STAGES shared-memory buffers, each one K-chunk of
//     KC bytes of the corpus tile and the query tile (two query planes for
//     B8), filled by cp.async 16-byte copies STAGES - 1 steps ahead.  KC
//     is 128 for int8 rows and 64 for packed ones, so at d = 128 a stage
//     holds whole rows and reads its corpus tile as one contiguous span.
//     The ring runs across output tiles, so the next tile's copies are in
//     flight while this tile's MMAs and stores run.  Rows are KC + 16 bytes
//     apart, so ldmatrix's eight 16-byte rows hit distinct banks.  Rows
//     that are not 16-byte aligned (width % 16 != 0, or a base off 16
//     bytes) take byte loads instead, the narrow path of the same kernel.
//     Bytes past the row are zero-filled in shared memory only; a zero
//     query byte makes any corpus byte there count 0.
//   * Epilogue: each warp writes its accumulators to its own staging
//     buffer, transposed to [query, corpus row], and streams them out as
//     full 128-byte lines with 16-byte st.global.cs (4-byte stores where
//     N % 4 != 0 leaves a row unaligned), masking ragged Q and N.  Only
//     __syncwarp orders it; the stores drain while the block waits for and
//     multiplies the next tile.
//   * Persistent blocks: as many as fit on the SMs (the occupancy API
//     sizes the grid), each owning the corpus tiles blockIdx.x, +
//     gridDim.x, ... and running every query tile on each in turn.  A
//     corpus tile comes from HBM once; its reads for the next query tiles
//     come back from L2 while they are hot.  Under the output's write
//     stream the corpus reads are what the stores wait behind, so the
//     fewer of them reach HBM the better.
//   * L2 (B7, B8b): the same dots, the same ring and the same stores; only
//     the staged values change, to -(|q|^2 + |x|^2 - 2 q . x).  Both norms
//     are summed from the fragments already in registers, so a call stays
//     one launch and reads nothing more: each lane `dp4a`s its A words
//     (B8b: the unpacked lo and hi words) into its two rows of each m16
//     group and its B words into its query of each n8 tile, and the
//     epilogue adds the four lanes of a row group with two shuffles.  A
//     zero pad byte unpacks to (-8, -8), so a packed row's sum is 128 too
//     high for every byte staged past its width; that count is the same
//     for every row and is taken off once.  The combine runs in uint32, so
//     the result wraps as the reference's int32 arithmetic does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MMA_NT = 256;          // threads per block (8 warps)
constexpr int STAGES = 3;            // ring depth
constexpr int ES = 32 + 4;           // staging row stride in int32

template <int QT, bool I4>
struct MmaCfg {
  // bytes of a row per ring stage, 128 for int8 and 64 for packed rows: at
  // d = 128 a stage holds whole rows and reads its corpus tile as one
  // contiguous span (a narrower chunk fetches each line in two halves)
  static constexpr int KC = I4 ? 64 : 128;
  static constexpr int SROW = KC + 16;         // shared row stride in bytes
  static constexpr int WARPS_N = QT >= 64 ? 2 : 1;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int BM = 32 * WARPS_M;      // corpus rows per tile
  static constexpr int WN = QT / WARPS_N;      // queries per warp
  static constexpr int NTILE = WN / 8;         // n8 tiles per warp
  static constexpr int EW = WN < 32 ? WN : 32; // queries per staging round
  static constexpr int P = I4 ? 2 : 1;         // query planes
  static constexpr int STAGE = (BM + P * QT) * SROW;
  static constexpr int SMEM = STAGES * STAGE + 8 * EW * ES * 4;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

// c += a (16 x 32, row) . b (32 x 8, col), s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// L2: s += the squares of the four s8 lanes of w
__device__ __forceinline__ void add_sq(int& s, uint32_t w) {
  s = __dp4a((int)w, (int)w, s);
}

// L2: the sum of v over the four lanes of this lane's row group
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// L2: -(qq + xx - 2 dot), wrapping as the reference's int32 arithmetic
__device__ __forceinline__ int neg_l2(int dot, uint32_t qq, uint32_t xx) {
  return (int)(0u - (qq + xx - 2u * (uint32_t)dot));
}

// Stage rows [row0, row0 + R) x bytes [k0, k0 + KC) of a [n_rows, width]
// byte matrix into `dst` (row stride SROW), zero past n_rows and width:
// cp.async 16-byte copies where `vec` (rows and base 16-byte aligned), else
// byte loads and a shared store per word.
template <int R, int KC, int SROW>
__device__ __forceinline__ void stage_rows(uint8_t* dst,
                                           const uint8_t* __restrict__ src,
                                           long long row0, long long n_rows,
                                           int width, int k0, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int SEGS = KC / 16, ALL = R * SEGS;
#pragma unroll
    for (int j = 0; j < (ALL + MMA_NT - 1) / MMA_NT; ++j) {
      const int i = tid + j * MMA_NT;
      if (ALL % MMA_NT == 0 || i < ALL) {
        const int r = i / SEGS, b = k0 + (i % SEGS) * 16;
        const bool ok = row0 + r < n_rows && b < width;
        cp_async16(dst + r * SROW + (i % SEGS) * 16,
                   ok ? src + (row0 + r) * width + b : src, ok ? 16 : 0);
      }
    }
  } else {
    constexpr int WORDS = KC / 4, ALL = R * WORDS;
#pragma unroll 4
    for (int j = 0; j < (ALL + MMA_NT - 1) / MMA_NT; ++j) {
      const int i = tid + j * MMA_NT;
      if (ALL % MMA_NT == 0 || i < ALL) {
        const int r = i / WORDS, b = k0 + (i % WORDS) * 4;
        uint32_t v = 0;
        if (row0 + r < n_rows) {
          const uint8_t* p = src + (row0 + r) * width + b;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (b + t < width) v |= (uint32_t)__ldg(p + t) << (8 * t);
        }
        *reinterpret_cast<uint32_t*>(dst + r * SROW + (i % WORDS) * 4) = v;
      }
    }
  }
}

// I4: x holds packed bytes, q0 / q1 the even / odd query halves (width
// bytes each); else x and q0 are int8 rows of width = d.  L2: negated
// squared L2 in place of the inner product.  The block owns corpus tiles
// blockIdx.x, + gridDim.x, ... (rows nt * BM ...) and runs every query
// tile (queries qt * QT ...) on each in turn.
template <int QT, bool I4, bool L2>
__global__ void __launch_bounds__(MMA_NT)
qmip_mma_kernel(const int8_t* __restrict__ q0, const int8_t* __restrict__ q1,
                const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                int Q, long long N, int width, bool x_vec, bool q_vec,
                bool out_vec) {
  using C = MmaCfg<QT, I4>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  const int g = lane >> 2, t4 = lane & 3;
  int32_t* stg = reinterpret_cast<int32_t*>(smem + STAGES * C::STAGE) +
                 warp * C::EW * ES;

  const int n_qt = (Q + QT - 1) / QT;
  const long long n_nt = (N + C::BM - 1) / C::BM;
  const int n_chunks = (width + C::KC - 1) / C::KC;
  const long long steps =
      ((n_nt - 1 - blockIdx.x) / gridDim.x + 1) * n_qt * n_chunks;
  // L2, packed rows: what the zero bytes staged past the row add to |x|^2
  [[maybe_unused]] const uint32_t x_pad =
      128u * (uint32_t)(n_chunks * C::KC - width);

  // the copy side of the ring runs STAGES - 1 steps ahead of the MMAs
  long long ld_nt = blockIdx.x;
  int ld_qt = 0, ld_chunk = 0, ld_slot = 0;
  auto load_next = [&]() {
    uint8_t* st = smem + ld_slot * C::STAGE;
    const long long n0 = ld_nt * C::BM;
    const long long qb = (long long)ld_qt * QT;
    const int k0 = ld_chunk * C::KC;
    uint8_t* qs = st + C::BM * C::SROW;
    stage_rows<C::BM, C::KC, C::SROW>(st, x, n0, N, width, k0, x_vec, tid);
    stage_rows<QT, C::KC, C::SROW>(qs, reinterpret_cast<const uint8_t*>(q0),
                                   qb, Q, width, k0, q_vec, tid);
    if constexpr (I4)
      stage_rows<QT, C::KC, C::SROW>(qs + QT * C::SROW,
                                     reinterpret_cast<const uint8_t*>(q1), qb,
                                     Q, width, k0, q_vec, tid);
    if (++ld_chunk == n_chunks) {
      ld_chunk = 0;
      if (++ld_qt == n_qt) {
        ld_qt = 0;
        ld_nt += gridDim.x;
      }
    }
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
  };

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < steps) load_next();
    cp_async_commit();
  }

  int acc[2][C::NTILE][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NTILE; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  // L2: this lane's parts of |x|^2 of rows mi * 16 + g (+ 8) and of |q|^2
  // of query g of each n8 tile, over the tile's K-chunks
  [[maybe_unused]] int xn[2][2] = {}, qn[C::NTILE] = {};

  long long nt = blockIdx.x;
  int qt = 0, chunk = 0, slot = 0;
  // ldmatrix row addresses of this lane: A (x4: rows 0-15, bytes +0 / +16),
  // B (x4: two n8 tiles, rows 0-7 / 8-15, bytes +0 / +16)
  const int a_off = (wm * 32 + (lane & 15)) * C::SROW + (lane >> 4) * 16;
  const int b_off = (wn * C::WN + (lane & 7) + ((lane >> 4) << 3)) * C::SROW +
                    ((lane >> 3) & 1) * 16;
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // step s has landed; slot s-1 is free
    if (s + STAGES - 1 < steps) load_next();
    cp_async_commit();

    const uint8_t* As = smem + slot * C::STAGE;
    const uint8_t* Bs = As + C::BM * C::SROW;
#pragma unroll
    for (int kk = 0; kk < C::KC / 32; ++kk) {
      uint32_t a[2][4], ah[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4(a[mi], As + a_off + mi * 16 * C::SROW + kk * 32);
        if constexpr (I4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t w = a[mi][e];
            a[mi][e] = __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
            ah[mi][e] = __vsub4((w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
          }
        }
        if constexpr (L2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // a[mi][e]: row g (e even), g + 8
            add_sq(xn[mi][e & 1], a[mi][e]);
            if constexpr (I4) add_sq(xn[mi][e & 1], ah[mi][e]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
        const uint8_t* Bp = Bs + p * QT * C::SROW + b_off + kk * 32;
        if constexpr (C::NTILE == 1) {
          uint32_t b0, b1;
          ldsm_x2(b0, b1, Bp);
          if constexpr (L2) {
            add_sq(qn[0], b0);
            add_sq(qn[0], b1);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_s8(acc[mi][0], p ? ah[mi] : a[mi], b0, b1);
        } else {
#pragma unroll
          for (int ni = 0; ni < C::NTILE; ni += 2) {
            uint32_t b[4];
            ldsm_x4(b, Bp + ni * 8 * C::SROW);
            if constexpr (L2) {
              add_sq(qn[ni], b[0]);
              add_sq(qn[ni], b[1]);
              add_sq(qn[ni + 1], b[2]);
              add_sq(qn[ni + 1], b[3]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_s8(acc[mi][ni], p ? ah[mi] : a[mi], b[0], b[1]);
              mma_s8(acc[mi][ni + 1], p ? ah[mi] : a[mi], b[2], b[3]);
            }
          }
        }
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if (++chunk < n_chunks) continue;

    // epilogue: this warp's 32 corpus rows x WN queries, EW queries a round
    const long long n0 = nt * C::BM + wm * 32;
    const long long qw = (long long)qt * QT + wn * C::WN;
    [[maybe_unused]] uint32_t xx[2][2];  // L2: |x|^2 of rows mi * 16 + g (+ 8)
    if constexpr (L2) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xx[mi][h] = (uint32_t)quad_sum(xn[mi][h]) - (I4 ? x_pad : 0u);
#pragma unroll
      for (int ni = 0; ni < C::NTILE; ++ni) qn[ni] = quad_sum(qn[ni]);
    }
#pragma unroll
    for (int rr = 0; rr < C::WN / C::EW; ++rr) {
#pragma unroll
      for (int nj = 0; nj < C::EW / 8; ++nj) {
        const int ni = rr * (C::EW / 8) + nj;
        const int ql = nj * 8 + 2 * t4;
        if constexpr (L2) {
          // |q|^2 of queries 2 t4 and 2 t4 + 1: row groups 2 t4, 2 t4 + 1
          const uint32_t qa = __shfl_sync(0xffffffffu, qn[ni], 8 * t4);
          const uint32_t qb = __shfl_sync(0xffffffffu, qn[ni], 8 * t4 + 4);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r = mi * 16 + g;
            stg[ql * ES + r] = neg_l2(acc[mi][ni][0], qa, xx[mi][0]);
            stg[(ql + 1) * ES + r] = neg_l2(acc[mi][ni][1], qb, xx[mi][0]);
            stg[ql * ES + r + 8] = neg_l2(acc[mi][ni][2], qa, xx[mi][1]);
            stg[(ql + 1) * ES + r + 8] = neg_l2(acc[mi][ni][3], qb, xx[mi][1]);
          }
        } else {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r = mi * 16 + g;
            stg[ql * ES + r] = acc[mi][ni][0];
            stg[(ql + 1) * ES + r] = acc[mi][ni][1];
            stg[ql * ES + r + 8] = acc[mi][ni][2];
            stg[(ql + 1) * ES + r + 8] = acc[mi][ni][3];
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < C::EW / 4; ++i) {
        const int idx = i * 32 + lane, ql = idx >> 3, v = idx & 7;
        const long long q = qw + rr * C::EW + ql;
        const long long n = n0 + v * 4;
        if (q >= Q || n >= N) continue;
        const int4 val = *reinterpret_cast<const int4*>(&stg[ql * ES + v * 4]);
        int32_t* o = out + q * N + n;
        if (out_vec && n + 3 < N) {
          __stcs(reinterpret_cast<int4*>(o), val);
        } else {
          const int e4[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) __stcs(o + e, e4[e]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NTILE; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    if constexpr (L2) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) xn[mi][0] = xn[mi][1] = 0;
#pragma unroll
      for (int ni = 0; ni < C::NTILE; ++ni) qn[ni] = 0;
    }
    chunk = 0;
    if (++qt == n_qt) {
      qt = 0;
      nt += gridDim.x;
    }
  }
}

// rows of `width` bytes from `p` take 16-byte loads (aligned rows)
bool rows16(const void* p, int width) {
  return ((uintptr_t)p & 15) == 0 && width % 16 == 0;
}

template <int QT, bool I4, bool L2>
cudaError_t launch_mma(const void* q0, const void* q1, const void* x,
                       void* out, int Q, long long N, int width,
                       cudaStream_t stream) {
  using C = MmaCfg<QT, I4>;
  // once per kernel: opt in to its shared memory, size the persistent grid
  struct Init {
    cudaError_t err;
    int blocks;
  };
  static const Init init = [] {
    Init r{cudaSuccess, 0};
    int dev = 0, sms = 0, per_sm = 0;
    r.err = cudaFuncSetAttribute(qmip_mma_kernel<QT, I4, L2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::SMEM);
    if (r.err == cudaSuccess) r.err = cudaGetDevice(&dev);
    if (r.err == cudaSuccess)
      r.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r.err == cudaSuccess)
      r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, qmip_mma_kernel<QT, I4, L2>, MMA_NT, C::SMEM);
    r.blocks = sms * per_sm;
    if (r.err == cudaSuccess && r.blocks == 0)
      r.err = cudaErrorInvalidConfiguration;
    return r;
  }();
  if (init.err != cudaSuccess) return init.err;
  const long long n_nt = (N + C::BM - 1) / C::BM;
  const int grid = (int)(n_nt < init.blocks ? n_nt : init.blocks);
  const bool q_vec = rows16(q0, width) && (q1 == nullptr || rows16(q1, width));
  const bool out_vec = ((uintptr_t)out & 15) == 0 && N % 4 == 0;
  qmip_mma_kernel<QT, I4, L2><<<grid, MMA_NT, C::SMEM, stream>>>(
      (const int8_t*)q0, (const int8_t*)q1, (const uint8_t*)x, (int32_t*)out,
      Q, N, width, rows16(x, width), q_vec, out_vec);
  return cudaGetLastError();
}

template <bool I4, bool L2>
cudaError_t launch_mma_bn(int bn, const void* q0, const void* q1,
                          const void* x, void* out, int Q, long long N,
                          int width, cudaStream_t st) {
  switch (bn) {
    case 8: return launch_mma<8, I4, L2>(q0, q1, x, out, Q, N, width, st);
    case 16: return launch_mma<16, I4, L2>(q0, q1, x, out, Q, N, width, st);
    case 32: return launch_mma<32, I4, L2>(q0, q1, x, out, Q, N, width, st);
    case 64: return launch_mma<64, I4, L2>(q0, q1, x, out, Q, N, width, st);
    case 128: return launch_mma<128, I4, L2>(q0, q1, x, out, Q, N, width, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// i4: 0 for int8 rows (q0 [Q, width], x [N, width] int8), 1 for packed int4
// (q0 / q1 the even / odd query halves [Q, width] int8, x [N, width] uint8
// packed bytes); l2: 0 inner product (B6 / B8a), 1 negated squared L2 (B7 /
// B8b); tile: queries per output tile (8, 16, 32, 64 or 128).  Writes out
// [Q, N] int32 on `stream`; returns the launch's cudaError_t (0 on
// success).
extern "C" int rt_qscore(int i4, int l2, int tile, const void* q0,
                         const void* q1, const void* x, void* out, int Q,
                         long long N, int width, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (width <= 0 || (i4 && q1 == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto launch = i4 ? (l2 ? launch_mma_bn<true, true>
                                : launch_mma_bn<true, false>)
                         : (l2 ? launch_mma_bn<false, true>
                               : launch_mma_bn<false, false>);
  return (int)launch(tile, q0, q1, x, out, Q, N, width, st);
}

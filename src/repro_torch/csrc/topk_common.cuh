// The running top-k shared by the fused scans: B2/B3 (fused_topk.cu) and
// B4/B5 (adc.cu), and (last section) the ring, tensor-core and per-warp
// list helpers of the int scans.
//
// Pass 1 of every fused scan keeps, per query of its block, a candidate
// buffer of `cap` 64-bit keys plus a threshold (the current k-th best
// key).  The buffers live in shared memory where they fit and in a
// global-memory scratch the wrapper allocates where they do not (wide k);
// every function here works through a pointer, so the placement is the
// caller's template flag and the shared-memory instances compile as they
// did before the global ones existed.  A scored row enters the buffer only if its key
// beats the threshold (`offer`); a bitonic sort truncates a buffer to its
// best k whenever one more insert round could overflow it (`compact`).
// `flush_partial` writes each query's best k of the block's corpus range
// to the [Q, S, k] partial-key scratch, and pass 2 (`merge_topk_kernel`,
// launched by `launch_merge`) merges the S partial lists of each query the
// same way and decodes ([Q, k] f32, [Q, k] i32).
//
// Order: (f32 score desc under the IEEE total order, row id asc), the
// reference's.  A (score, id) pair is one 64-bit key: the order-preserving
// bits of the f32 score above ~id, so larger key = better and no two rows
// tie; a tie in score at the threshold is decided by id, never floods the
// buffer.  Key 0 is "no candidate" and decodes to (float32 min, -1), the
// reference's sentinel for pad rows, masked rows and k > n_valid.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr float NEG = -3.40282346638528859812e+38f;  // float32 min

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(float s, long long id) {
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(~(unsigned int)id);
}

__device__ __forceinline__ float key_score(u64 key) {
  unsigned int u = (unsigned int)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(~(unsigned int)(key & 0xffffffffull));
}

// Offer one candidate to query qi's buffer: kept only if it beats the
// threshold.  The caller guarantees room (at most cap - count inserts
// between two `compact` calls).
__device__ __forceinline__ void offer(u64* buf, const u64* thresh, int* cnt,
                                      int qi, int cap, u64 key) {
  if (key > thresh[qi]) {
    const int pos = atomicAdd(&cnt[qi], 1);
    buf[(size_t)qi * cap + pos] = key;
  }
}

// Block-wide: for each of the nq buffers whose count exceeds `limit`
// (limit < 0: all of them), sort the buffer descending and keep its best
// k; the k-th key becomes the threshold.  Every thread must call it.
__device__ void compact(u64* buf, u64* thresh, int* cnt, int* need, int nq,
                        int cap, int k, int limit) {
  __syncthreads();
  if ((int)threadIdx.x < nq) need[threadIdx.x] = cnt[threadIdx.x] > limit;
  __syncthreads();
  bool any = false;
  for (int i = 0; i < nq; ++i) any |= need[i] != 0;
  if (!any) return;
  for (int e = threadIdx.x; e < nq * cap; e += blockDim.x) {
    const int qi = e / cap;
    if (need[qi] && e - qi * cap >= cnt[qi]) buf[e] = 0ull;
  }
  __syncthreads();
  const int half = cap >> 1;
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < nq * half; e += blockDim.x) {
        const int qi = e / half;
        if (!need[qi]) continue;
        const int i = e - qi * half;
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        u64* b = buf + (long long)qi * cap;
        const u64 a = b[lo], c = b[hi];
        if (desc ? (a < c) : (a > c)) {
          b[lo] = c;
          b[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  if ((int)threadIdx.x < nq && need[threadIdx.x]) {
    const int c = min(cnt[threadIdx.x], k);
    cnt[threadIdx.x] = c;
    if (c >= k) thresh[threadIdx.x] = buf[(long long)threadIdx.x * cap + k - 1];
  }
  __syncthreads();
}

// End of pass 1: truncate every buffer of the block to its best k and
// write them as split `split` of queries q_base.. in the [Q, S, k] scratch
// (key 0 where a query holds fewer than k candidates).
__device__ void flush_partial(u64* buf, u64* thresh, int* cnt, int* need,
                              int nq, int cap, int k, u64* part, int q_base,
                              int Q, int split, int n_splits) {
  compact(buf, thresh, cnt, need, nq, cap, k, -1);
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
    const int qi = e / k, j = e % k;
    const int q = q_base + qi;
    if (q < Q)
      part[((size_t)q * n_splits + split) * k + j] =
          j < cnt[qi] ? buf[(size_t)qi * cap + j] : 0ull;
  }
}

// GBUF: the [Q, cap] merge buffers live in `gbuf` (global memory), for k
// whose buffer does not fit in shared memory; shared memory then holds the
// threshold and counters only.
template <bool GBUF>
__global__ void __launch_bounds__(NT)
merge_topk_kernel(const u64* __restrict__ part, u64* __restrict__ gbuf,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int n_splits, int k, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* base = reinterpret_cast<u64*>(smem);
  const int q = blockIdx.x;
  u64* buf = GBUF ? gbuf + (size_t)q * cap : base;  // [cap]
  u64* thresh = GBUF ? base : base + cap;           // [1]
  int* cnt = reinterpret_cast<int*>(thresh + 1);
  int* need = cnt + 1;
  const long long total = (long long)n_splits * k;
  const u64* src = part + (size_t)q * total;
  if (threadIdx.x == 0) {
    cnt[0] = 0;
    thresh[0] = 0ull;
  }
  __syncthreads();
  for (long long base_e = 0; base_e < total; base_e += NT) {
    const long long e = base_e + threadIdx.x;
    if (e < total) offer(buf, thresh, cnt, 0, cap, src[e]);
    compact(buf, thresh, cnt, need, 1, cap, k, cap - NT);
  }
  compact(buf, thresh, cnt, need, 1, cap, k, -1);
  for (int j = threadIdx.x; j < k; j += NT) {
    const u64 key = j < cnt[0] ? buf[j] : 0ull;
    out_s[(size_t)q * k + j] = key ? key_score(key) : NEG;
    out_i[(size_t)q * k + j] = key ? key_id(key) : -1;
  }
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Pass 2: one block per query merges its n_splits partial lists, in a
// buffer of next_pow2(k + NT) keys: in shared memory when `gbuf` is null,
// else in gbuf ([Q, next_pow2(k + NT)] keys, the wrapper's scratch).
cudaError_t launch_merge(const u64* part, u64* gbuf, void* out_s, void* out_i,
                         int Q, int n_splits, int k, cudaStream_t st) {
  const int merge_cap = next_pow2(k + NT);
  const size_t smem = (gbuf ? 0 : (size_t)merge_cap * 8) + 8 + 8;
  auto fn = gbuf ? merge_topk_kernel<true> : merge_topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fn<<<Q, NT, smem, st>>>(part, gbuf, (float*)out_s, (int*)out_i, n_splits,
                          k, merge_cap);
  return cudaGetLastError();
}

// ---- the int scans' ring, tensor-core and per-warp upkeep helpers (B2
// int8 and B3 in fused_topk.cu, B5 in adc.cu) -------------------------------

// Sort a warp's list of `cap` keys (a power of two) descending: the
// bitonic network of `compact` above, one warp, no block barrier.  The
// whole warp calls it.
__device__ void warp_sort_desc(u64* b, int cap, int lane) {
  for (int size = 2; size <= cap; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll 4
      for (int i = lane; i < cap / 2; i += 32) {
        // 2 * stride * (i / stride) + i % stride, stride a power of two
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = b[lo], c = b[hi];
        if (desc ? (a < c) : (a > c)) {
          b[lo] = c;
          b[hi] = a;
        }
      }
      __syncwarp();
    }
}

// Truncate a warp's list holding c keys to its best k: zero-fill past c,
// sort, and raise the threshold to the k-th key once there are k.
__device__ void warp_compact(u64* b, int& c, u64& thr, int cap, int k,
                             int lane) {
  __syncwarp();
  for (int e = c + lane; e < cap; e += 32) b[e] = 0ull;
  __syncwarp();
  warp_sort_desc(b, cap, lane);
  c = min(c, k);
  if (c >= k) thr = b[k - 1];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// n of the 16 (4) bytes are copied, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// mbarriers in shared memory (the int8 scan's ring)
__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// arrives once every cp.async this thread issued before it has landed
__device__ __forceinline__ void mbar_arrive_copies(u64* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
               "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
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
// Stage bytes [k0, k0 + KC) of rows [row0, row0 + R) of an [n_rows, width]
// int8 matrix into dst (rows `stride` bytes apart) with NTH threads, zero
// past n_rows and width: mode 2 16-byte cp.async (rows and base 16-byte
// aligned), mode 1 4-byte cp.async (4-byte aligned), mode 0 byte loads and
// one shared store a word.
template <int R, int NTH, int KC>
__device__ __forceinline__ void i8_stage(uint8_t* dst, int stride,
                                         const int8_t* __restrict__ src,
                                         long long row0, long long n_rows,
                                         int width, int k0, int mode, int tid) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
  if (mode == 2) {
    constexpr int SEGS = KC / 16, ALL = R * SEGS;
#pragma unroll
    for (int j = 0; j < (ALL + NTH - 1) / NTH; ++j) {
      const int i = tid + j * NTH;
      if (ALL % NTH == 0 || i < ALL) {
        const int r = i / SEGS, b = k0 + (i % SEGS) * 16;
        const bool ok = row0 + r < n_rows && b < width;
        cp_async16(dst + r * stride + (i % SEGS) * 16,
                   ok ? s + (row0 + r) * width + b : s, ok ? 16 : 0);
      }
    }
  } else {
    constexpr int WORDS = KC / 4, ALL = R * WORDS;
#pragma unroll 4
    for (int j = 0; j < (ALL + NTH - 1) / NTH; ++j) {
      const int i = tid + j * NTH;
      if (ALL % NTH == 0 || i < ALL) {
        const int r = i / WORDS, b = k0 + (i % WORDS) * 4;
        uint8_t* to = dst + r * stride + (i % WORDS) * 4;
        const bool ok = row0 + r < n_rows && b < width;
        if (mode == 1) {
          cp_async4(to, ok ? s + (row0 + r) * width + b : s, ok ? 4 : 0);
        } else {
          uint32_t v = 0;
          if (ok) {
            const uint8_t* p = s + (row0 + r) * width + b;
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (b + t < width) v |= (uint32_t)__ldg(p + t) << (8 * t);
          }
          *reinterpret_cast<uint32_t*>(to) = v;
        }
      }
    }
  }
}

// The smallest int32 score whose f32 cast (round to nearest even) orders
// above the key `thr` (INT_MIN while a list holds fewer than k keys): a row
// scanned after every row in the list beats `thr` exactly when its int
// score reaches this bound, since its larger id loses a tie in f32 score.
// Past INT_MAX the bound is INT_MAX, which lets a superset through.
__device__ int int_bound(u64 thr) {
  if (thr == 0ull) return (int)0x80000000u;
  const float t = key_score(thr);
  const double m =
      0.5 * ((double)t + (double)nextafterf(t, __int_as_float(0x7f800000)));
  double v = ceil(m);
  if (__ll2float_rn((long long)v) <= t) v += 1.0;
  return v > 2147483647.0 ? 0x7fffffff : (int)v;
}

// copies of int8 rows of `width` bytes from p: 2 16-byte, 1 4-byte, 0 bytes
int i8_copy_mode(const void* p, int width) {
  if (((uintptr_t)p & 15) == 0 && width % 16 == 0) return 2;
  if (((uintptr_t)p & 3) == 0 && width % 4 == 0) return 1;
  return 0;
}

}  // namespace

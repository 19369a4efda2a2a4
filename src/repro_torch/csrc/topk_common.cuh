// The running top-k shared by the fused scans: B2/B3 (fused_topk.cu) and
// B4/B5 (adc.cu).
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
constexpr int ROW_LANES = 64;           // most inserts per query per round
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

}  // namespace

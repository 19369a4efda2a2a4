// B1: Eq. 1 clamped-linear quantization, [N, d] f32 -> [N, d] int8.
//
// Replaces the TPU kernel repro/kernels/quantize.py `quantize_pallas`
// (body `_quantize_kernel`), which streams (BN, d) tiles through VMEM with
// the per-dim constants resident.
//
// Bound on the H100: memory.  Each element reads 4 bytes and writes 1, and
// does a handful of flops, so the kernel can do no better than 5 bytes per
// element over 3.35 TB/s.  Design: one grid-stride pass, a block per row
// at a time, consecutive threads on consecutive columns (coalesced 128-byte
// reads, the constants come from L1).  Every rounding step is explicit so
// the codes equal the plain version's bit for bit: subtract, multiply by
// 2^B (exact), IEEE-rounded division (__fdiv_rn, no reciprocal), round half
// to even (rintf), clamp.  No fused multiply-add can form: each step is a
// _rn intrinsic.  Never build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ lo,
                                const float* __restrict__ hi,
                                const float* __restrict__ zero,
                                int8_t* __restrict__ out,
                                long long n_rows, int d, float scale,
                                float qmin, float qmax) {
  for (long long r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const float* xr = x + r * d;
    int8_t* orow = out + r * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      float span = fmaxf(__fsub_rn(hi[j], lo[j]), 1e-12f);
      float t = __fmul_rn(scale, __fsub_rn(xr[j], zero[j]));
      float v = rintf(__fdiv_rn(t, span));
      v = fminf(fmaxf(v, qmin), qmax);
      orow[j] = (int8_t)(int)v;
    }
  }
}

}  // namespace

extern "C" int rt_quantize(const void* x, const void* lo, const void* hi,
                           const void* zero, void* out, long long n_rows,
                           int d, int bits, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  const long long max_blocks = 132LL * 32;
  const int blocks = (int)(n_rows < max_blocks ? n_rows : max_blocks);
  const float scale = (float)(1 << bits);
  const float qmin = -(float)(1 << (bits - 1));
  const float qmax = (float)((1 << (bits - 1)) - 1);
  quantize_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)lo, (const float*)hi,
      (const float*)zero, (int8_t*)out, n_rows, d, scale, qmin, qmax);
  return (int)cudaGetLastError();
}

// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel / rmsnorm_2d, wrapper ops.py:rmsnorm): fp32 inside,
// output in x's dtype, as the oracle ref.py:rmsnorm_ref computes it.
//
// Bound: memory.  The kernel reads x once and writes y once (the scale is
// d values), about 4 flops an element; at the LM residual stream's
// (16384, 4096) that is 268 MB in bf16, 0.080 ms at 3.35 TB/s (0.160 ms in
// fp32).
//
// Design: one warp per row, eight rows a block.  A lane reads 16 bytes at a
// time (8 bf16 or 4 fp32 values, neighbouring lanes on neighbouring
// addresses), sums the squares in fp32, and the warp reduces the sum with
// shuffles, so no shared memory and no second kernel.  The second pass
// reads the row again (from L1/L2: a row is at most tens of KB) to scale
// and store it in x's dtype.  Rows past n are masked (the TPU wrapper pads
// them instead); a row whose length or start is not 16-byte aligned takes
// a scalar loop.  x and the scale may differ in dtype (the model's norms
// see bf16 activations and fp32 scales).  The kernel runs on the caller's
// stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // warps, so rows, per block
constexpr int THREADS = ROWS * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ out,
               long long n, int d, float eps, int vec) {
  constexpr int VEC = 16 / sizeof(TX);
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // masked rows: the whole warp leaves together
  const TX* xr = x + row * d;
  TX* yr = out + row * d;

  float ss = 0.f;
  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      alignas(16) TX e[VEC];
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = to_f(e[i]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = to_f(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);

  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      alignas(16) TX e[VEC];
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) from_f(&e[i], to_f(e[i]) * inv * to_f(scale[c + i]));
      *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(e);
    }
  } else {
    for (int c = lane; c < d; c += 32) from_f(&yr[c], to_f(xr[c]) * inv * to_f(scale[c]));
  }
}

template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* out, long long n, int d, float eps,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  const int vec = (d % VEC == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long blocks = (n + ROWS - 1) / ROWS;
  rmsnorm_kernel<TX, TS><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const TX*)x, (const TS*)scale, (TX*)out, n, d, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out (n, d) contiguous, scale (d,) contiguous; x_bf16 / scale_bf16
// give each one's dtype (0 = float32, 1 = bfloat16), out has x's dtype.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 = ok).
// The caller checks n >= 1, d >= 1 and n / 8 < 2^31.
int rmsnorm_fwd(const void* x, const void* scale, void* out, long long n, int d, float eps,
                int x_bf16, int scale_bf16, void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    return scale_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n, d, eps, s)
                      : launch<__nv_bfloat16, float>(x, scale, out, n, d, eps, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, out, n, d, eps, s)
                    : launch<float, float>(x, scale, out, n, d, eps, s);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

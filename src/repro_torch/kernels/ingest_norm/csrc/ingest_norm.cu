// ingest_norm for Hopper (sm_90a): uint8 (B,H,W,C) -> normalized (B,C,H,W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ingest_norm/kernel.py
// (_ingest_kernel / ingest_norm_batched): y = x * scale_c + bias_c with
// scale = 1/(255*std), bias = -mean/std, one fma an element, and the
// HWC -> CHW layout flip, to float32 or bfloat16, for C from 1 to 4.
//
// Bound: memory.  The kernel reads B*H*W*C bytes and writes B*C*H*W output
// elements, B*H*W*C*(1 + out_bytes) bytes in all.  At the main path's
// (64,224,224,3) -> f32 that is 48.2 MB, 14.4 us at the H100 SXM's
// 3.35 TB/s; the arithmetic is nothing beside it.  The first version (8x32
// pixel tiles, one byte a thread a load, 12,544 blocks) took 56 us warm.
//
// Design: the flip is (H*W, C) -> (C, H*W) per image, so a run of P
// consecutive pixels of one image is one contiguous run of P*C input bytes,
// and in each of the C output planes one contiguous run of P outputs.  One
// block takes one run (P = 2560 pixels: 1,280 blocks of 128 threads at the
// path shape, one wave at the 12 blocks an SM that 40 registers a thread
// allow):
//  * vector path: it loads the run's bytes as 16-byte vectors into shared
//    memory, then each thread takes 16/out_bytes consecutive pixels (4 for
//    f32, 8 for bf16), reads their C channels as 32-bit words and writes
//    one 16-byte vector to each plane: every global load and store is
//    16 bytes, and a warp's stores cover 512 contiguous bytes of a plane.
//    It needs every run's byte offset and length to be multiples of 16
//    (H*W*C % 16 == 0, the input 16-byte aligned) and the plane offsets to
//    be whole vectors (H*W a multiple of 16/out_bytes); the wrapper decides
//    by shape (ops.path_for) and the kernel refuses a vector launch that
//    breaks this.
//  * scalar path, any other shape: the same runs, loaded a byte a thread
//    (consecutive threads, consecutive bytes) and stored an element a
//    thread (consecutive threads, consecutive outputs of a plane).
// Where it departs from the TPU kernel: that one takes one image a grid
// step with the whole image in VMEM; here 20 blocks share an image (its
// 150 KB do not fit a block's shared memory) and run in parallel.  The
// arithmetic is the same fma.  The kernel runs on the caller's stream and
// allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int RUN = 2560;  // pixels a block
constexpr int MAX_C = 4;
constexpr int THREADS = 128;

struct Affine {
  float scale[MAX_C];
  float bias[MAX_C];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of outputs from PIX = 16/sizeof(Out) values
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = q;
}

template <typename Out, int C, bool VEC>
__global__ void __launch_bounds__(THREADS)
ingest_norm_kernel(const uint8_t* __restrict__ in, Out* __restrict__ out, long long HW,
                   int runs, Affine aff) {
  __shared__ __align__(16) uint8_t buf[RUN * MAX_C];
  const long long b = blockIdx.x / runs;
  const long long p0 = (long long)(blockIdx.x - b * runs) * RUN;
  const int n = (int)min((long long)RUN, HW - p0);  // pixels of this run
  const uint8_t* src = in + (b * HW + p0) * C;
  Out* dst = out + b * C * HW + p0;

  if constexpr (VEC) {
    constexpr int PIX = 16 / sizeof(Out);  // pixels a thread, one vector a plane
    constexpr int WORDS = PIX * C / 4;     // their input bytes, in 32-bit words
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* buf4 = reinterpret_cast<uint4*>(buf);
    for (int i = threadIdx.x; i < n * C / 16; i += THREADS) buf4[i] = __ldg(src4 + i);
    __syncthreads();
    for (int e = threadIdx.x; e < n / PIX; e += THREADS) {
      uint32_t wd[WORDS];
      const uint32_t* src_w = reinterpret_cast<const uint32_t*>(buf + e * PIX * C);
#pragma unroll
      for (int i = 0; i < WORDS; ++i) wd[i] = src_w[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v[PIX];
#pragma unroll
        for (int p = 0; p < PIX; ++p) {
          const int byte = p * C + c;
          const float x = (float)((wd[byte >> 2] >> (8 * (byte & 3))) & 0xffu);
          v[p] = fmaf(x, aff.scale[c], aff.bias[c]);
        }
        store16(dst + c * HW + e * PIX, v);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * C; i += THREADS) buf[i] = src[i];
    __syncthreads();
    for (int i = threadIdx.x; i < C * n; i += THREADS) {
      const int c = i / n;
      const int p = i - c * n;
      store(dst + c * HW + p, fmaf((float)buf[p * C + c], aff.scale[c], aff.bias[c]));
    }
  }
}

template <typename Out, int C, bool VEC>
int launch(const void* in, void* out, long long HW, int runs, int blocks, const Affine& aff,
           cudaStream_t s) {
  ingest_norm_kernel<Out, C, VEC><<<blocks, THREADS, 0, s>>>(
      (const uint8_t*)in, (Out*)out, HW, runs, aff);
  return (int)cudaGetLastError();
}

template <typename Out, int C>
int launch_path(int vec, const void* in, void* out, long long HW, int runs, int blocks,
                const Affine& aff, cudaStream_t s) {
  return vec ? launch<Out, C, true>(in, out, HW, runs, blocks, aff, s)
             : launch<Out, C, false>(in, out, HW, runs, blocks, aff, s);
}

template <typename Out, int C>
int occupancy(int vec) {
  int n = 0;
  cudaError_t e = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            &n, ingest_norm_kernel<Out, C, true>, THREADS, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            &n, ingest_norm_kernel<Out, C, false>, THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// out_bf16 = 0 writes float32, 1 writes bfloat16; vec = 1 takes the vector
// path, which the shape must allow (ops.path_for; refused otherwise).  The
// caller checks: 1 <= C <= 4, B * ceil(H*W / 2560) < 2^31, contiguous
// tensors on the current device.
int ingest_norm_u8(const void* in, void* out, int B, int H, int W, int C,
                   const float* scale, const float* bias, int out_bf16, int vec,
                   void* stream) {
  if (C < 1 || C > MAX_C || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  const int pix = out_bf16 ? 8 : 4;
  if (vec && ((HW * C) % 16 != 0 || HW % pix != 0 || (uintptr_t)in % 16 != 0 ||
              (uintptr_t)out % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long runs = (HW + RUN - 1) / RUN;
  if (B * runs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Affine aff;
  for (int c = 0; c < MAX_C; ++c) {
    aff.scale[c] = c < C ? scale[c] : 0.f;
    aff.bias[c] = c < C ? bias[c] : 0.f;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)(B * runs);
  const int r = (int)runs;
#define INGEST_C(Out, c) \
  if (C == c) return launch_path<Out, c>(vec, in, out, HW, r, blocks, aff, s);
  if (out_bf16) {
    INGEST_C(__nv_bfloat16, 1) INGEST_C(__nv_bfloat16, 2)
    INGEST_C(__nv_bfloat16, 3) INGEST_C(__nv_bfloat16, 4)
  } else {
    INGEST_C(float, 1) INGEST_C(float, 2) INGEST_C(float, 3) INGEST_C(float, 4)
  }
#undef INGEST_C
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the kernel for C, the output type and the path; a negative count is a
// CUDA error code.  `threads` and `run_pixels` get the block's threads and
// pixels.
int ingest_norm_occupancy(int C, int out_bf16, int vec, int* threads, int* run_pixels) {
  *threads = THREADS;
  *run_pixels = RUN;
  switch (C + 8 * (out_bf16 != 0)) {
    case 1: return occupancy<float, 1>(vec);
    case 2: return occupancy<float, 2>(vec);
    case 3: return occupancy<float, 3>(vec);
    case 4: return occupancy<float, 4>(vec);
    case 9: return occupancy<__nv_bfloat16, 1>(vec);
    case 10: return occupancy<__nv_bfloat16, 2>(vec);
    case 11: return occupancy<__nv_bfloat16, 3>(vec);
    case 12: return occupancy<__nv_bfloat16, 4>(vec);
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* ingest_norm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

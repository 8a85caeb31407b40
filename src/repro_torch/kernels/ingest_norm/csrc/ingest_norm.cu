// ingest_norm for Hopper (sm_90a): uint8 (B,H,W,C) -> normalized (B,C,H,W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ingest_norm/kernel.py
// (_ingest_kernel / ingest_norm_batched): y = x * scale_c + bias_c with
// scale = 1/(255*std), bias = -mean/std, and the HWC -> CHW layout flip.
//
// Bound: memory.  The kernel reads B*H*W*C bytes and writes B*C*H*W output
// elements, B*H*W*C*(1 + out_bytes) bytes in all, with one fma per element.
// At the main path's (64,224,224,3) -> f32 that is 48.2 MB, about 14 us at
// the H100 SXM's 3.35 TB/s.
//
// Design: the flip is a transpose, so neither the 1-byte HWC loads nor the
// 4-byte CHW stores coalesce unless a tile is staged on chip.  One block
// takes one image's tile of TILE_H rows x TILE_W pixels: its threads load
// the tile's bytes row by row (consecutive threads, consecutive bytes) into
// shared memory, then write each channel plane of the tile row by row
// (consecutive threads, consecutive w), so a warp stores 32 consecutive
// output elements.  Blocks are independent; ragged edges are masked.  The
// kernel runs on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 32;
constexpr int MAX_C = 4;
constexpr int THREADS = 256;

struct Affine {
  float scale[MAX_C];
  float bias[MAX_C];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
ingest_norm_kernel(const uint8_t* __restrict__ in, Out* __restrict__ out,
                   int H, int W, int C, Affine aff) {
  __shared__ uint8_t tile[TILE_H * TILE_W * MAX_C];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int rows = min(TILE_H, H - y0);
  const int cols = min(TILE_W, W - x0);
  const int row_bytes = cols * C;  // bytes of one tile row in HWC
  const size_t img = (size_t)H * W * C;
  const uint8_t* src = in + (size_t)b * img + ((size_t)y0 * W + x0) * C;

  for (int i = threadIdx.x; i < rows * row_bytes; i += THREADS) {
    const int r = i / row_bytes;
    const int k = i - r * row_bytes;
    tile[r * TILE_W * MAX_C + k] = src[(size_t)r * W * C + k];
  }
  __syncthreads();

  const size_t plane = (size_t)H * W;
  Out* dst = out + (size_t)b * img + (size_t)y0 * W + x0;
  for (int i = threadIdx.x; i < C * TILE_H * TILE_W; i += THREADS) {
    const int c = i / (TILE_H * TILE_W);
    const int rem = i - c * (TILE_H * TILE_W);
    const int r = rem / TILE_W;
    const int w = rem - r * TILE_W;
    if (r < rows && w < cols) {
      const float x = (float)tile[r * TILE_W * MAX_C + w * C + c];
      store(dst + c * plane + (size_t)r * W + w, fmaf(x, aff.scale[c], aff.bias[c]));
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// out_bf16 = 0 writes float32, 1 writes bfloat16.  The caller checks shapes:
// 1 <= C <= 4, B <= 65535, contiguous tensors on the current device.
int ingest_norm_u8(const void* in, void* out, int B, int H, int W, int C,
                   const float* scale, const float* bias, int out_bf16,
                   void* stream) {
  if (C < 1 || C > MAX_C || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Affine aff;
  for (int c = 0; c < MAX_C; ++c) {
    aff.scale[c] = c < C ? scale[c] : 0.f;
    aff.bias[c] = c < C ? bias[c] : 0.f;
  }
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* src = (const uint8_t*)in;
  if (out_bf16) {
    ingest_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        src, (__nv_bfloat16*)out, H, W, C, aff);
  } else {
    ingest_norm_kernel<float><<<grid, THREADS, 0, s>>>(src, (float*)out, H, W, C, aff);
  }
  return (int)cudaGetLastError();
}

const char* ingest_norm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

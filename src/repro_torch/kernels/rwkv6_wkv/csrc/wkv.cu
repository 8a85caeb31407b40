// RWKV-6 WKV recurrence for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// (_wkv_kernel / wkv_chunked, wrapper ops.py:wkv): per (batch, head), with a
// D x D fp32 state S,
//     y_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// returning y and the final state, as the oracle ref.py:wkv_ref computes it.
//
// Bound: memory.  The kernel reads r, k, v, w (B,S,H,D) fp32 once each (and
// u and s0) and writes y (B,S,H,D) and sT (B,H,D,D); at the RWKV path's
// (4,4096,64,64) that is 1.35 GB, 0.40 ms at 3.35 TB/s.  It does about
// 5*D^2 flops per token and head (2.15e10 there), 0.32 ms at the 67 TFLOP/s
// fp32 CUDA-core peak, so bytes bound it, though not by much.
//
// Design, and how it departs from the TPU kernel:
//  * The TPU kernel recasts the recurrence in chunked matrix form for its
//    matrix unit, dividing k by a product of up to 32 decays, which
//    underflows fp32 when the decays are small.  In fp32 Hopper's tensor
//    cores are TF32 only, too coarse for the oracle's 2e-4, so this kernel
//    runs the per-token recurrence itself (the form the TPU kernel's own
//    docstring names for GPUs): the oracle's arithmetic, with no division.
//  * One block per (batch, head); its D threads own one column j of S each,
//    D fp32 registers.  A token costs each thread D fmas for y_j = sum_i r_i
//    S_ij and 2*D for S_ij <- w_i S_ij + k_i v_j: no exchange between
//    threads except the bonus sum_i r_i u_i k_i, which is one scalar per
//    token, reduced per tile with warp shuffles.
//  * r, k, v, w are staged through shared memory a tile of 1024/D tokens at
//    a time, double-buffered with cp.async, so the next tile's loads overlap
//    this tile's recurrence.  Threads read r_i, k_i, w_i as float4
//    broadcasts (every lane the same address).
//  * The (B,S,H,D) inputs are read in place through their strides (no
//    transpose to (BH,S,D)); any S is handled by masking the last tile (no
//    padding); a nonzero s0 is loaded straight into the state registers (no
//    analytic fold).
// The kernel runs on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

struct Args {
  const float* in[4];  // r, k, v, w: (B,S,H,D) fp32, last dimension contiguous
  const float* u;      // (H, D)
  const float* s0;     // (B, H, D, D)
  float* y;            // (B, S, H, D), contiguous
  float* sT;           // (B, H, D, D)
  int S, H;
  long long st[4][3];  // element strides (batch, token, head) of r, k, v, w
};

template <int D>
struct Shape {
  static constexpr int TT = 1024 / D;         // tokens per staged tile
  static constexpr int NW = (D + 31) / 32;    // warps per block
  static constexpr int CH = D / 4;            // 16-byte chunks per token row
};

// Sum over the block's lanes of one warp (D lanes when D < 32).
template <int D>
__device__ __forceinline__ float warp_sum(float p) {
  constexpr int W = D < 32 ? D : 32;
  constexpr unsigned mask = D < 32 ? ((1u << (D & 31)) - 1u) : 0xffffffffu;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) p += __shfl_xor_sync(mask, p, off);
  return p;
}

// Start the async copy of tokens [t0, t0 + nt) of r, k, v, w into buf
// (4 arrays of TT*D floats), and commit it as one group.
template <int D>
__device__ __forceinline__ void stage(float* buf, const float* const* base,
                                      const long long* tstride, int t0, int nt) {
  using Sh = Shape<D>;
  for (int q = threadIdx.x; q < nt * Sh::CH; q += D) {
    const int t = q / Sh::CH;
    const int c4 = (q - t * Sh::CH) * 4;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      __pipeline_memcpy_async(buf + x * Sh::TT * D + t * D + c4,
                              base[x] + (long long)(t0 + t) * tstride[x] + c4, 16);
    }
  }
  __pipeline_commit();
}

template <int D>
__global__ void __launch_bounds__(D) wkv_kernel(Args a) {
  using Sh = Shape<D>;
  constexpr int TT = Sh::TT;
  __shared__ __align__(16) float tile[2][4 * TT * D];
  __shared__ float part[TT][Sh::NW];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;

  const float* base[4];
  long long tstride[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    base[x] = a.in[x] + b * a.st[x][0] + h * a.st[x][2];
    tstride[x] = a.st[x][1];
  }

  float s[D];  // column j of the state
  const float* s0 = a.s0 + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = s0[i * D + j];
  const float uj = a.u[h * D + j];

  float* ycol = a.y + ((size_t)b * a.S * a.H + h) * D + j;
  const size_t ystride = (size_t)a.H * D;
  const int n_tiles = (a.S + TT - 1) / TT;

  stage<D>(tile[0], base, tstride, 0, min(TT, a.S));
  for (int c = 0; c < n_tiles; ++c) {
    const int t0 = c * TT;
    const int nt = min(TT, a.S - t0);
    if (c + 1 < n_tiles) {
      stage<D>(tile[(c + 1) & 1], base, tstride, t0 + TT, min(TT, a.S - t0 - TT));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* rt = tile[c & 1];
    const float* kt = rt + TT * D;
    const float* vt = kt + TT * D;
    const float* wt = vt + TT * D;

    // the bonus r_t . (u * k_t) of each token of the tile
    for (int t = 0; t < nt; ++t) {
      const float p = warp_sum<D>(rt[t * D + j] * (uj * kt[t * D + j]));
      if (lane == 0) part[t][warp] = p;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vj = vt[t * D + j];
      const float4* r4 = reinterpret_cast<const float4*>(rt + t * D);
      const float4* k4 = reinterpret_cast<const float4*>(kt + t * D);
      const float4* w4 = reinterpret_cast<const float4*>(wt + t * D);
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rr = r4[q];
        const float4 kk = k4[q];
        const float4 ww = w4[q];
        y0 = fmaf(rr.x, s[4 * q + 0], y0);
        y1 = fmaf(rr.y, s[4 * q + 1], y1);
        y2 = fmaf(rr.z, s[4 * q + 2], y2);
        y3 = fmaf(rr.w, s[4 * q + 3], y3);
        s[4 * q + 0] = fmaf(ww.x, s[4 * q + 0], kk.x * vj);
        s[4 * q + 1] = fmaf(ww.y, s[4 * q + 1], kk.y * vj);
        s[4 * q + 2] = fmaf(ww.z, s[4 * q + 2], kk.z * vj);
        s[4 * q + 3] = fmaf(ww.w, s[4 * q + 3], kk.w * vj);
      }
      float bonus = 0.f;
#pragma unroll
      for (int x = 0; x < Sh::NW; ++x) bonus += part[t][x];
      ycol[(size_t)(t0 + t) * ystride] = ((y0 + y1) + (y2 + y3)) + bonus * vj;
    }
    __syncthreads();  // the buffer and part[] are refilled next iteration
  }

  float* sT = a.sT + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) sT[i * D + j] = s[i];
}

template <int D>
int launch(const Args& a, int BH, cudaStream_t stream) {
  wkv_kernel<D><<<BH, D, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w (B,S,H,D) fp32, each addressed through `strides` (12 element
// strides: batch, token and head of r, k, v, w; the last dimension is
// contiguous); u (H,D), s0 and sT (B,H,D,D) and y (B,S,H,D) contiguous.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 = ok).
// The caller checks what the kernel assumes: D in {8,16,32,64,128}; every
// pointer and token row 16-byte aligned; B*H < 2^31.
int wkv_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* s0, void* y, void* sT, int B, int S, int H, int D,
            const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.in[0] = (const float*)r;
  a.in[1] = (const float*)k;
  a.in[2] = (const float*)v;
  a.in[3] = (const float*)w;
  a.u = (const float*)u;
  a.s0 = (const float*)s0;
  a.y = (float*)y;
  a.sT = (float*)sT;
  a.S = S;
  a.H = H;
  for (int x = 0; x < 4; ++x)
    for (int i = 0; i < 3; ++i) a.st[x][i] = strides[3 * x + i];
  cudaStream_t s = (cudaStream_t)stream;
  const int BH = B * H;
  switch (D) {
    case 8: return launch<8>(a, BH, s);
    case 16: return launch<16>(a, BH, s);
    case 32: return launch<32>(a, BH, s);
    case 64: return launch<64>(a, BH, s);
    case 128: return launch<128>(a, BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// RWKV-6 WKV recurrence for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// (_wkv_kernel / wkv_chunked, wrapper ops.py:wkv): per (batch, head), with a
// D x D fp32 state S,
//     y_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// returning y and the final state, as the oracle ref.py:wkv_ref computes it.
//
// Bound: the kernel reads r, k, v, w (B,S,H,D) fp32 once each (and u and
// s0) and writes y (B,S,H,D) and sT (B,H,D,D): at the RWKV path's
// (4,4096,64,64) that is 1.35 GB, 0.403 ms at 3.35 TB/s.  The recurrence
// needs 3 fp32 instructions per state entry and token (an fma for y, a
// multiply k_i v_j and an fma for S): 1.29e10 lane instructions there,
// 0.33 ms at the 132 x 128 lanes' issue rate.  This design reaches about
// half the bytes bound.  What holds it there is not measured (no profiler
// on the card); the working guess is the delivery of r, k, w and v from
// shared memory into registers (about 128 bytes a clock an SM), each
// r_i, k_i, w_i loaded by every lane that holds a column of row i.  The
// first version, one lane a state column (1.47 ms), loaded 3*D floats a
// lane for D state entries; a lane that holds C columns loads them once
// for C.
//
// Design:
//  * Register blocking: a lane holds a block of the state, R = D/G rows of
//    C columns (G = C = 4 at D = 64: 16 x 4, 64 threads a head, two heads
//    an SM).  Each r_i, k_i, w_i it loads feeds C columns and each v_j R
//    rows, so a lane takes (3R + C)/4 16-byte loads a token for R*C
//    entries.  Lane g of a column block owns the float4 chunks g, g + G,
//    ... of the rows, so the G lanes of a quarter warp read G banks.
//  * y_j is a chain of fmas over the lane's rows, then a reduce-scatter
//    over the G lanes with __shfl_xor_sync (log2(G) steps, each lane keeps
//    half of the columns it holds): each lane ends with C/G finished
//    columns and stores them, a warp whole 32-byte sectors of the row.
//  * The token loop is software-pipelined by one token (token t's fmas are
//    independent of token t - 1's shuffles) and unrolled by two.
//  * The bonus r_t . (u * k_t) is one scalar per token, the same for every
//    column.  A cooperative pass computes it for the next tile while this
//    tile's tokens run (D/8 lanes a token, 8 rows a lane, a shuffle tree):
//    under one instruction a token and lane, and no barrier of its own.
//  * r, k, v, w are staged through shared memory in tiles of 2048/D tokens
//    (32 KB), a ring of three, with cp.async issued two tiles ahead (the
//    bonus pass reads a tile one tile early), so each copy overlaps a
//    whole tile of recurrence.  One __syncthreads per tile.
//  * The (B,S,H,D) inputs are read in place through their strides (no
//    transpose to (BH,S,D)); any S is handled by masking the last tile (no
//    padding); a nonzero s0 is loaded straight into the state registers.
// Where it departs from the TPU kernel: the TPU kernel recasts the
// recurrence in chunked matrix form for its matrix unit, dividing k by a
// product of up to 32 decays, which underflows fp32 when the decays are
// small; in fp32 Hopper's tensor cores are TF32 only, too coarse for the
// oracle's 2e-4.  This kernel runs the per-token recurrence (the form the
// TPU kernel's own docstring names for GPUs): the oracle's arithmetic with
// no division, its sums taken in another order (a chain per lane, then the
// xor tree over G lanes; tests/test_torch_wkv.py emulates that order).
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

template <int D, int G, int C>
struct Shape {
  static constexpr int R = D / G;             // state rows a lane holds
  static constexpr int NT = D / C * G;        // threads a block (one head)
  static constexpr int TT = 2048 / D;         // tokens a staged tile (32 KB)
  static constexpr int NS = 3;                // tiles in the ring
  static constexpr int CH = D / 4;            // 16-byte chunks a token row
  static constexpr int BL = D / 8;            // lanes a token in the bonus pass
  static constexpr int W = C >= G ? C / G : 1;        // columns a lane stores
  static constexpr int DUP = C >= G ? 0 : G / C - 1;  // lane bits that hold copies
  static constexpr int SMEM = NS * 4 * TT * D * 4;    // dynamic shared bytes
  // two blocks an SM (2 x 96 KB of tiles fit) except at D = 128, where
  // half as many heads have 4x the state: one block, up to 255 registers
  static constexpr int MINB = D >= 128 ? 1 : 2;
  static_assert(R % 4 == 0 && C % 4 == 0 && G <= 32 && NT >= BL && BL >= 1 &&
                    NT % CH == 0 && TT % (NT / CH) == 0,
                "unsupported (D, G, C)");
};

template <int N>
__device__ __forceinline__ unsigned lanes_mask() {
  return N >= 32 ? 0xffffffffu : ((1u << (N & 31)) - 1u);
}

// Start the async copy of tokens [t0, t0 + nt) of r, k, v, w into buf
// (4 arrays of TT*D floats), and commit it as one group.  Thread i copies
// the 16-byte chunk i % CH of tokens i / CH, i / CH + NT / CH, ...
template <int D, int G, int C>
__device__ __forceinline__ void stage(float* buf, const float* const* src,
                                      const long long* tstride, int t0, int nt) {
  using Sh = Shape<D, G, C>;
  constexpr int STEP = Sh::NT / Sh::CH;  // tokens between a thread's chunks
  const int t = threadIdx.x / Sh::CH;
  const int c4 = (threadIdx.x % Sh::CH) * 4;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float* from = src[x] + (long long)(t0 + t) * tstride[x] + c4;
    const long long step = STEP * tstride[x];
    float* to = buf + (x * Sh::TT + t) * D + c4;
#pragma unroll
    for (int k = 0; k < Sh::TT / STEP; ++k)
      if (t + k * STEP < nt) __pipeline_memcpy_async(to + k * STEP * D, from + k * step, 16);
  }
  __pipeline_commit();
}

// bon[t] = r_t . (u * k_t) for the tile's nt tokens: BL lanes a token, each
// over the 8 rows of chunks `part` and `part + BL`, then a shuffle tree.
template <int D, int G, int C>
__device__ __forceinline__ void bonus(const float* rt, const float* kt, const float4 (&uu)[2],
                                      float* bon, int nt) {
  using Sh = Shape<D, G, C>;
  constexpr int PER = Sh::NT / Sh::BL;  // tokens a pass
  const int part = threadIdx.x % Sh::BL;
  const int tl = threadIdx.x / Sh::BL;
#pragma unroll
  for (int base = 0; base < Sh::TT; base += PER) {
    const int t = base + tl;
    float p = 0.f;
    if (t < nt) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float4 rr = reinterpret_cast<const float4*>(rt + t * D)[part + m * Sh::BL];
        const float4 kk = reinterpret_cast<const float4*>(kt + t * D)[part + m * Sh::BL];
        p = fmaf(rr.x, uu[m].x * kk.x, p);
        p = fmaf(rr.y, uu[m].y * kk.y, p);
        p = fmaf(rr.z, uu[m].z * kk.z, p);
        p = fmaf(rr.w, uu[m].w * kk.w, p);
      }
    }
#pragma unroll
    for (int off = Sh::BL / 2; off > 0; off >>= 1)
      p += __shfl_xor_sync(lanes_mask<Sh::NT>(), p, off);
    if (part == 0 && t < nt) bon[t] = p;
  }
}

// Reduce-scatter of a lane's C column partials p over the G lanes of its
// group: at the step of distance `off` a lane keeps half of the columns it
// holds, adds its partner's partials of them and hands over the other half;
// once one column is left, the remaining steps add it whole.  Each lane
// ends with the sums of W columns starting at the returned offset; lanes
// that differ only in DUP bits hold the same ones.  Every sum is the xor
// tree over the G lanes.
template <int G, int C>
__device__ __forceinline__ int reduce_scatter(float (&p)[C], int g, unsigned mask) {
  int base = 0;
#pragma unroll
  for (int s = 0; (G >> (s + 1)) > 0; ++s) {
    const int off = G >> (s + 1);
    const int width = C >> s;  // columns held before this step
    if (width > 1) {  // a constant once the loop is unrolled
      const int half = width / 2;
      const bool up = g & off;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? p[i] : p[i + half];
        const float keep = up ? p[i + half] : p[i];
        p[i] = keep + __shfl_xor_sync(mask, send, off);
      }
      base += up ? half : 0;
    } else {
      p[0] += __shfl_xor_sync(mask, p[0], off);
    }
  }
  return base;
}

// One token of the recurrence on the lane's R x C block of the state: its
// part of y for its C columns (one fma chain a column over its rows), and
// S <- diag(w) S + k v^T.  The lane's rows are the float4 chunks g, g + G,
// g + 2G, ... of r, k, w; its columns j0 .. j0 + C - 1 of v.
template <int D, int G, int C>
__device__ __forceinline__ void token(float (&s)[D / G][C], float (&y)[C], const float* rt,
                                      const float* kt, const float* vt, const float* wt,
                                      int g, int j0) {
  float v[C];
#pragma unroll
  for (int x = 0; x < C; x += 4) {
    const float4 vv = *reinterpret_cast<const float4*>(vt + j0 + x);
    v[x] = vv.x, v[x + 1] = vv.y, v[x + 2] = vv.z, v[x + 3] = vv.w;
  }
#pragma unroll
  for (int x = 0; x < C; ++x) y[x] = 0.f;
  const float4* r4 = reinterpret_cast<const float4*>(rt) + g;
  const float4* k4 = reinterpret_cast<const float4*>(kt) + g;
  const float4* w4 = reinterpret_cast<const float4*>(wt) + g;
#pragma unroll
  for (int q = 0; q < D / G / 4; ++q) {
    const float4 rr = r4[q * G], kk = k4[q * G], ww = w4[q * G];
    const float ri[4] = {rr.x, rr.y, rr.z, rr.w};
    const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
    const float wi[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < C; ++x) {
        y[x] = fmaf(ri[i], s[4 * q + i][x], y[x]);
        s[4 * q + i][x] = fmaf(wi[i], s[4 * q + i][x], ki[i] * v[x]);
      }
  }
}

template <int D, int G, int C>
__global__ void __launch_bounds__(Shape<D, G, C>::NT, Shape<D, G, C>::MINB)
wkv_kernel(Args a) {
  using Sh = Shape<D, G, C>;
  constexpr int TT = Sh::TT, R = Sh::R;
  extern __shared__ __align__(16) float tiles[];  // [NS][4][TT][D]
  __shared__ float bon[2][TT];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int g = threadIdx.x % G;       // row group
  const int j0 = threadIdx.x / G * C;  // first of the lane's C columns

  const float* src[4];
  long long tstride[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    src[x] = a.in[x] + b * a.st[x][0] + h * a.st[x][2];
    tstride[x] = a.st[x][1];
  }

  float s[R][C];
  const float* s0 = a.s0 + (size_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int x = 0; x < C; ++x) s[4 * q + c][x] = s0[(4 * (q * G + g) + c) * D + j0 + x];
  float4 uu[2];  // u on the bonus pass's rows
  {
    const float4* u4 = reinterpret_cast<const float4*>(a.u + h * D);
    const int part = threadIdx.x % Sh::BL;
    uu[0] = u4[part];
    uu[1] = u4[part + Sh::BL];
  }

  float* yrow = a.y + ((size_t)b * a.S * a.H + h) * D + j0;
  const size_t ystride = (size_t)a.H * D;
  const int n_tiles = (a.S + TT - 1) / TT;
  auto buf = [&](int c) { return tiles + (c % Sh::NS) * 4 * TT * D; };
  auto ntok = [&](int c) { return min(TT, a.S - c * TT); };
  const unsigned mask = lanes_mask<Sh::NT>();

  stage<D, G, C>(buf(0), src, tstride, 0, ntok(0));
  if (n_tiles > 1) stage<D, G, C>(buf(1), src, tstride, TT, ntok(1));
  __pipeline_wait_prior(0);
  __syncthreads();
  bonus<D, G, C>(buf(0), buf(0) + TT * D, uu, bon[0], ntok(0));

  for (int c = 0; c < n_tiles; ++c) {
    // tile c + 1 has landed (this thread's copies), and after the barrier
    // everyone's; bon[c & 1] is written; every thread is done with tile
    // c - 1, whose buffer takes tile c + 2
    __pipeline_wait_prior(0);
    __syncthreads();
    if (c + 2 < n_tiles) stage<D, G, C>(buf(c + 2), src, tstride, (c + 2) * TT, ntok(c + 2));
    if (c + 1 < n_tiles)
      bonus<D, G, C>(buf(c + 1), buf(c + 1) + TT * D, uu, bon[(c + 1) & 1], ntok(c + 1));

    const float* rt = buf(c);
    const float* kt = rt + TT * D;
    const float* vt = kt + TT * D;
    const float* wt = vt + TT * D;
    const float* bt = bon[c & 1];
    const int t0 = c * TT;
    const int nt = ntok(c);
    // Software-pipelined by one token: token t's fmas are independent of
    // token t - 1's shuffles, so the two interleave.
    auto finish = [&](float (&y)[C], int t) {
      const int col = reduce_scatter<G, C>(y, g, mask);
      if ((g & Sh::DUP) == 0) {
        const float bonus_t = bt[t];
#pragma unroll
        for (int x = 0; x < Sh::W; ++x)
          yrow[(size_t)(t0 + t) * ystride + col + x] =
              fmaf(bonus_t, vt[t * D + j0 + col + x], y[x]);
      }
    };
    float yp[C];
    token<D, G, C>(s, yp, rt, kt, vt, wt, g, j0);
#pragma unroll 2
    for (int t = 1; t < nt; ++t) {
      float y[C];
      token<D, G, C>(s, y, rt + t * D, kt + t * D, vt + t * D, wt + t * D, g, j0);
      finish(yp, t - 1);
#pragma unroll
      for (int x = 0; x < C; ++x) yp[x] = y[x];
    }
    finish(yp, nt - 1);
  }

  float* sT = a.sT + (size_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int x = 0; x < C; ++x) sT[(4 * (q * G + g) + c) * D + j0 + x] = s[4 * q + c][x];
}

template <int D, int G, int C>
int launch(const Args& a, int BH, cudaStream_t stream) {
  using Sh = Shape<D, G, C>;
  cudaError_t e = cudaFuncSetAttribute(wkv_kernel<D, G, C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return (int)e;
  wkv_kernel<D, G, C><<<BH, Sh::NT, Sh::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int G, int C>
int occupancy() {
  using Sh = Shape<D, G, C>;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(wkv_kernel<D, G, C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv_kernel<D, G, C>, Sh::NT,
                                                       Sh::SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

// The (D, G, C) kernel built for each head dim D; ops.py's LAYOUT names
// the same ones.
#define WKV_CASES(X) X(8, 2, 4) X(16, 4, 4) X(32, 8, 4) X(64, 4, 4) X(128, 16, 8)

}  // namespace

extern "C" {

// r, k, v, w (B,S,H,D) fp32, each addressed through `strides` (12 element
// strides: batch, token and head of r, k, v, w; the last dimension is
// contiguous); u (H,D), s0 and sT (B,H,D,D) and y (B,S,H,D) contiguous.
// A lane holds C columns of G lanes' share of the rows: (D, G, C) must be
// the case of WKV_CASES for D.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 = ok).
// The caller checks what the kernel assumes: every pointer and token row
// 16-byte aligned; B*H < 2^31.
int wkv_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* s0, void* y, void* sT, int B, int S, int H, int D, int G,
            int C, const long long* strides, void* stream) {
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
  cudaStream_t st = (cudaStream_t)stream;
  const int BH = B * H;
#define WKV_LAUNCH(d, g, c) \
  if (D == d && G == g && C == c) return launch<d, g, c>(a, BH, st);
  WKV_CASES(WKV_LAUNCH)
#undef WKV_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM of the (D, G, C) kernel (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor), its threads a block and dynamic shared bytes; a
// negative count is a CUDA error code, 0 an unbuilt one.
int wkv_occupancy(int D, int G, int C, int* threads, int* smem_bytes) {
#define WKV_OCC(d, g, c)                   \
  if (D == d && G == g && C == c) {        \
    *threads = Shape<d, g, c>::NT;         \
    *smem_bytes = Shape<d, g, c>::SMEM;    \
    return occupancy<d, g, c>();           \
  }
  WKV_CASES(WKV_OCC)
#undef WKV_OCC
  return 0;
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

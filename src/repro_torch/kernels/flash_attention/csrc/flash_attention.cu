// Flash-attention forward for Hopper (sm_90a) on the CUDA cores: fp32 at
// head dims 16, 32, 64, 128 and 192, and bf16 at 16 and 32.  bf16 at 64,
// 128 and 192 runs on the tensor cores (flash_attention_sm90.cu); the
// wrapper routes by dtype and head dim, never by failure.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_bh, wrapper ops.py:flash_attention):
// o = softmax(q k^T / sqrt(D), causal mask with q_offset = T - S) v, as an
// online softmax over key tiles with a running max m, a running sum l and an
// fp32 accumulator; masked scores are -1e30 and the result is acc / max(l,
// 1e-20), as in the TPU kernel.
//
// Bound: operations.  Causal attention does 2*B*Hq*S^2*D flops (q k^T and
// p v over the lower triangle) on B*(Hq*S + 2*Hkv*T + Hq*S)*D elements of
// input and output; at the LM path's shape in fp32, q (4,32,4096,128) and
// kv (4,8,4096,128), that is 5.5e11 flops on 671 MB: 8.2 ms at the 67
// TFLOP/s fp32 peak of the CUDA cores, 0.20 ms at 3.35 TB/s.  This kernel
// is the exact one: fp32 products in fp32, where TF32 tensor cores would
// miss the fp32 gate of 1e-5.
//
// Design, and how it departs from the TPU grid:
//  * One block per (batch*head, 64-row q tile); the block loops over 64-key
//    tiles itself (the TPU's sequential third grid axis).  Blocks of the
//    last q tiles, which have the most key tiles under a causal mask, are
//    launched first.
//  * Key tiles entirely above the diagonal are never loaded.
//  * GQA: the block reads kv head h / (Hq/Hkv) directly; nothing is repeated.
//  * Ragged S and T: rows >= S are neither loaded nor stored; keys >= T score
//    -inf (weight exactly 0) instead of being padded.
//  * Shared memory holds Q^T and K^T (D x 64, so a thread reads 4 rows or 4
//    keys as one float4), V (64 x D) and P (64 x 68, padded against bank
//    conflicts), all in fp32: 113 KB at D = 128, 161 KB at D = 192 (above
//    48 KB only as dynamic shared memory, so the launch raises the limit).
//  * 256 threads as 16 x 16: thread (ty, tx) owns score rows 4ty..4ty+3 and
//    key columns 4tx..4tx+3, and output rows 4ty..4ty+3 at D/16 columns, so
//    a row's max and sum reduce over the 16 lanes of a half-warp with
//    shuffles and the rescaling by exp(m_old - m_new) needs no shared memory.
//  * Inputs are read through their strides (the last dimension contiguous),
//    so the model's (B,S,H,D) projections are used without a transposing copy.
// The kernel runs on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PSTRIDE = BK + 4;
constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, S, T, causal;
  float scale;
  // element strides of (batch, head, position); the last dimension is contiguous
  long long sq[3], sk[3], sv[3], so[3];
};

// Vector loads of one row chunk into fp32 registers: 16 bytes at a time.
template <typename T> struct Ld;
template <> struct Ld<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Ld<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int VEC>
__device__ __forceinline__ void load_smem(const float* p, float* x) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * BQ + (size_t)D * BK + (size_t)BK * D + (size_t)BQ * PSTRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
  constexpr int L = Ld<T>::N;            // elements per 16-byte load
  constexpr int DC = D / L;              // 16-byte chunks per row
  constexpr int CPT = D / 16;            // output columns per thread
  constexpr int VEC = CPT >= 4 ? 4 : CPT;
  constexpr int NG = CPT / VEC;          // column groups of VEC per thread

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* Ks = Qs + D * BQ;                       // [D][BK]
  float* Vs = Ks + D * BK;                       // [BK][D]
  float* Ps = Vs + BK * D;                       // [BQ][PSTRIDE]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const int off = a.causal ? a.T - a.S : 0;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  T* ob = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];

  // Q tile, transposed to [d][row]; rows past S are zero.
  for (int idx = tid; idx < DC * BQ; idx += THREADS) {
    const int r = idx % BQ, dc = idx / BQ;
    float x[L];
    if (q0 + r < a.S) {
      Ld<T>::load(qb + (long long)(q0 + r) * a.sq[2] + dc * L, x);
    } else {
#pragma unroll
      for (int e = 0; e < L; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < L; ++e) Qs[(dc * L + e) * BQ + r] = x[e];
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  // keys the tile's last row can see under the causal mask: 0 .. q0+BQ-1+off
  const int kv_end = a.causal ? min(a.T, q0 + BQ + off) : a.T;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < DC * BK; idx += THREADS) {
      const int c = idx % BK, dc = idx / BK;
      float x[L];
      if (k0 + c < a.T) {
        Ld<T>::load(kb + (long long)(k0 + c) * a.sk[2] + dc * L, x);
      } else {
#pragma unroll
        for (int e = 0; e < L; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < L; ++e) Ks[(dc * L + e) * BK + c] = x[e];
    }
    for (int idx = tid; idx < DC * BK; idx += THREADS) {
      const int c = idx / DC, dc = idx % DC;
      float x[L];
      if (k0 + c < a.T) {
        Ld<T>::load(vb + (long long)(k0 + c) * a.sv[2] + dc * L, x);
      } else {
#pragma unroll
        for (int e = 0; e < L; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < L; e += 4)
        *reinterpret_cast<float4*>(&Vs[c * D + dc * L + e]) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
    __syncthreads();

    // scores s = q k^T for rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * BQ + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Ks[d * BK + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax, rescale the accumulator, publish p
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j] * a.scale;
        if (kpos >= a.T) {
          x = -INFINITY;  // past the keys: weight exactly 0
        } else if (a.causal && kpos > qpos) {
          x = NEG;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * PSTRIDE + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PSTRIDE + c]);
        pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[CPT];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          load_smem<VEC>(&Vs[(c + cc) * D + g * 16 * VEC + tx * VEC], &vv[g * VEC]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pr[i][cc], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < a.S) {
      const float denom = fmaxf(l[i], 1e-20f);
      T* orow = ob + (long long)r * a.so[2];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          store(orow + g * 16 * VEC + tx * VEC + e, acc[i][g * VEC + e] / denom);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, B * a.Hq);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<float, 16>(a, B, stream);
    case 32: return launch<float, 32>(a, B, stream);
    case 64: return launch<float, 64>(a, B, stream);
    case 128: return launch<float, 128>(a, B, stream);
    case 192: return launch<float, 192>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<__nv_bfloat16, 16>(a, B, stream);
    case 32: return launch<__nv_bfloat16, 32>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;  // the tensor-core kernel's
  }
}

}  // namespace

extern "C" {

// q (B,Hq,S,D), k and v (B,Hkv,T,D), o (B,Hq,S,D), each addressed through
// `strides` (12 element strides: batch, head and position of q, k, v, o; the
// last dimension is contiguous).  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = ok).  The caller checks what the
// kernel assumes: D in {16,32,64,128,192} for fp32 and {16,32} for bf16; Hq
// a multiple of Hkv; 16-byte aligned rows; S <= T when causal; B*Hq <= 65535.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int S, int T, int D, const long long* strides, int causal,
                        int bf16, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.T = T; a.causal = causal;
  a.scale = (float)(1.0 / sqrt((double)D));  // 1/sqrt(D) rounded once, as the TPU kernel's
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch_bf16(a, B, D, s) : dispatch_f32(a, B, D, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Flash-attention backward for Hopper (sm_90a) in bf16 on the tensor cores:
// dq, dk and dv of o = softmax(q k^T / sqrt(D), causal mask with q_offset =
// T - S) v from q, k, v, o, the forward's per-row log-sum-exp and do.
//
// Replaces no TPU kernel: the reference's Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py) defines no VJP, and the
// reference trains through its plain attention.  The port added it so that
// training reaches the forward kernel (flash_attention_sm90.cu) at all: the
// plain chunked attention it replaces wrote and reread (B, Hkv, G, 1024, T)
// score tensors several times a layer and took about 60 % of granite's
// train step.
//
// Bound: operations.  Over the causal triangle the backward does five
// products where the forward does two (S = Q K^T and dP = dO V^T again,
// then dV = P^T dO, dK = dS^T Q and dQ = dS K): 10 D flops a (query, key)
// pair, about 2.5 forward-equivalents.  At the train step's microbatch, q
// (2,32,4096,128) and kv (2,8,4096,128), that is 6.9e11 flops, 0.69 ms at
// the 989 TFLOP/s bf16 peak, against 268 MB of q, k, v, o, do, dq, dk, dv
// (0.08 ms at 3.35 TB/s).  What the design does about it:
//  * Three kernels on the caller's stream: delta (D_i = rowsum(dO o O), fp32,
//    a warp a row, on O to about 2^-16: the bf16 output plus what its
//    rounding lost, which the forward stores beside it), the main kernel,
//    and a convert of the fp32 dQ sums to bf16 in q's own layout, scaled.
//  * Main kernel: one block for each (batch, kv head, 64-column group of
//    dK, dV and dQ, 128-key tile), the heaviest key tiles (the first: every
//    query sees them) launched first.  K and V are loaded once; the block walks the
//    q tiles of 64 rows from the last down to the diagonal, and within each
//    the G = Hq/Hkv query heads of its kv head, so GQA's sum for dK and dV
//    stays in registers and is stored once, with no atomics, and every
//    block of a (batch, kv head) reduces into the same dQ rows at about the
//    same time (they stay in L2).  Tiles wholly above the diagonal are
//    never visited.
//  * Warp specialisation as in the forward: a producer warpgroup (one
//    thread issues every TMA load: K and V once, then Q, dO, lse and delta
//    of each (q tile, head) through a ring of two stages behind "full" and
//    "empty" mbarriers) and two consumer warpgroups, each owning 64 of the
//    block's keys.  A consumer computes, with fp32 accumulation:
//      S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both from shared
//      memory, K-major);
//      P^T = 2^(S^T c - lse log2 e) and dS^T = P^T o (dP^T - Delta) in
//      registers (c = log2(e)/sqrt(D));
//      dV += P^T dO and dK += dS^T Q (wgmma with P^T and dS^T as the
//      register A operand: the S^T accumulator of queries 16c..16c+15 is
//      exactly the A fragment of k-slice c, as in the forward; dO and Q
//      are MN-major B operands);
//      dQ = dS K over its own 64 keys and the block's columns: dS^T goes
//      through the warpgroup's own shared memory (bf16, stored [key][query]
//      in the 128-byte swizzle, so the product reads it as an MN-major A
//      with no transpose).  Nothing waits on the other consumer, so one
//      warpgroup's products run while the other computes its softmax.
//    Rounding as the plain route's autograd: bf16 P for dV and bf16 dS for
//    dQ and dK; dP, Delta and the softmax stay fp32.
//  * dQ: each consumer stages its fp32 tile in shared memory and adds it to
//    a zeroed fp32 scratch with one bulk reduce (cp.reduce.async.bulk .add),
//    both consumers into the same tile; the scratch is laid out tile by
//    tile in the accumulator's own register order, which the convert kernel
//    undoes.  The order of those sums changes from run to run (about 2^-24
//    of a partial sum each).
//  * Registers, and why a block takes 64 columns: a consumer holds dK and
//    dV for its 64 keys and the block's 64 columns (32 fp32 each), S^T and
//    dP^T (32 each), then the bf16 fragments of P^T and dS^T, and dQ's 32
//    once dV and dK's products are done: about 130 a thread at the peak,
//    with setmaxnreg giving the consumers 240 and the producer 24.  With
//    all 128 columns of D = 128 in one block (64 fp32 each for dK and dV)
//    ptxas kept one of them in local memory and serialised every wgmma
//    (C7512), whatever the tile's shape: 4.1-8.9 ms at the path shape
//    against 2.9 ms with two column groups, which recompute S^T and dP^T
//    each (1.4x the tensor work).  D = 192 takes three groups, with a ring
//    of one stage (shared memory is full).  Shared-memory addresses pass
//    through an empty asm once a tile, so the compiler builds each wgmma
//    descriptor next to its use instead of keeping dozens of loop-invariant
//    ones in registers.
//  * Masks only where a tile crosses the diagonal, S or T: past T a key's
//    P is 0 (TMA fills its row with zeros, which would score 0), and past
//    S a row's P is 0 (its lse is padding).
//
// Shapes: q (B,Hq,S,D), k, v (B,Hkv,T,D), o and do as q, D in {64, 128,
// 192}; q, k, v and do are read through tensor maps built on their views'
// strides (the model's (B,S,H,D) projections in place), dq, dk and dv
// written through their strides.  The kernels allocate nothing; the C entry
// point returns the first launch's cudaGetLastError() that is not 0.
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 64;         // q rows a tile: S^T's n, dQ's m
constexpr int BK = 128;        // keys a block: two consumer warpgroups of 64
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int NBOX = D / DB;              // 64-column boxes across a row
  static constexpr int DC = 64;                     // a block's dK, dV and dQ columns
  static constexpr int NCG = D / DC;                // column groups (blocks) across D
  static constexpr int STAGES = D > 128 ? 1 : 2;    // Q / dO / lse / delta ring (192: smem is full)
  static constexpr int Q_BYTES = BQ * D * 2;        // a Q or dO tile
  static constexpr int KV_BYTES = BK * D * 2;       // K or V
  static constexpr int DS_BYTES = 64 * BQ * 2;      // a consumer's dS^T, [key][query]
  static constexpr int DQ_BYTES = BQ * DC * 4;      // a consumer's fp32 dQ tile
  static constexpr int SMEM = 2 * KV_BYTES + STAGES * 2 * Q_BYTES + CONSUMERS * DS_BYTES +
                              CONSUMERS * DQ_BYTES + STAGES * 2 * BQ * 4 + 1024;  // + alignment slack
  static_assert(D % DB == 0, "D must be a multiple of 64");
  static_assert(SMEM <= 232448, "over the 227 KB a block may have");
};

struct Args {
  const float* lse;       // (B*Hq) rows of ls: each query's log-sum-exp, natural log
  const float* delta;     // the same layout: rowsum(dO o O), 0 past S
  float* dq_acc;          // zeroed fp32 dQ tiles (B, Hq, nqt, NCG, BQ * DC)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int Hq, Hkv, S, T, causal, nqt;
  long long ls;
  float scale, scale_log2;  // 1/sqrt(D) (rounded once, as the forward's), and * log2(e)
  long long sdk[3], sdv[3]; // element strides of dk's and dv's (batch, head, position)
  signed char pos[4][3];    // q, k, v, do: the map dimension of rows, heads, batch
};

// The fp32 dQ tile of q tile m, column group cg of head (b, h).
__host__ __device__ __forceinline__ long long dq_tile(int b, int h, int m, int cg, int Hq, int nqt,
                                                      int ncg, int tile) {
  return (((long long)(b * Hq + h) * nqt + m) * ncg + cg) * tile;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, const Args a) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];
  // tiles start on 1024 B, where the 128-byte swizzle pattern repeats
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* vs = ks + G::KV_BYTES;
  uint8_t* qs = vs + G::KV_BYTES;                   // stage s at qs + s * Q_BYTES
  uint8_t* dos = qs + STAGES * G::Q_BYTES;          // dO, likewise
  uint8_t* dss = dos + STAGES * G::Q_BYTES;         // consumer w's dS^T at dss + w * DS_BYTES
  uint8_t* dqs = dss + CONSUMERS * G::DS_BYTES;     // consumer w's dQ tile at dqs + w * DQ_BYTES
  float* lses = reinterpret_cast<float*>(dqs + CONSUMERS * G::DQ_BYTES);  // stage s: + s * BQ
  float* dels = lses + STAGES * BQ;

  const int k0 = blockIdx.y * BK;                   // key tile 0, the heaviest, first
  const int cg = blockIdx.x % G::NCG;
  const int bhk = blockIdx.x / G::NCG;
  const int b = bhk / a.Hkv, hk = bhk - b * a.Hkv;
  const int GQ = a.Hq / a.Hkv;
  const int off = a.causal ? a.T - a.S : 0;
  // the first q tile that sees key k0 under the causal mask (k0 <= q + off)
  const int m_lo = a.causal ? max(0, k0 - off) / BQ : 0;
  const int n_it = (a.nqt - m_lo) * GQ;             // (q tile, head) pairs, tiles from the last down

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == CONSUMERS) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(&kv_full, 2 * G::KV_BYTES);
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x)
        tma_load(ks + x * BK * SPAN, &kmap, &kv_full, x * DB, a.pos[1], k0, hk, b);
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x)
        tma_load(vs + x * BK * SPAN, &vmap, &kv_full, x * DB, a.pos[2], k0, hk, b);
      for (int it = 0; it < n_it; ++it) {
        const int m = a.nqt - 1 - it / GQ, h = hk * GQ + it % GQ;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);  // consumers are done
        mbar_expect_tx(&full[s], 2 * G::Q_BYTES + 2 * BQ * 4);
#pragma unroll
        for (int x = 0; x < G::NBOX; ++x)
          tma_load(qs + s * G::Q_BYTES + x * BQ * SPAN, &qmap, &full[s], x * DB, a.pos[0], m * BQ,
                   h, b);
#pragma unroll
        for (int x = 0; x < G::NBOX; ++x)
          tma_load(dos + s * G::Q_BYTES + x * BQ * SPAN, &omap, &full[s], x * DB, a.pos[3],
                   m * BQ, h, b);
        const long long r = (long long)(b * a.Hq + h) * a.ls + m * BQ;
        bulk_load(lses + s * BQ, a.lse + r, BQ * 4, &full[s]);
        bulk_load(dels + s * BQ, a.delta + r, BQ * 4, &full[s]);
      }
    }
  } else {
    // ---- consumer warpgroup w: keys k0 + 64 w .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = group;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int key0 = k0 + 64 * w + warp * 16 + lane / 4;  // this thread's keys: key0 and key0 + 8
    const int col = 2 * (lane % 4);                        // its first column of every 8
    constexpr uint32_t SBO = 8 * SPAN;                     // 8 rows: one swizzle atom
    const float c = a.scale_log2;
    const uint32_t kw0 = smem_u32(ks + 64 * w * SPAN);     // this warpgroup's keys in each box
    const uint32_t vw0 = smem_u32(vs + 64 * w * SPAN);
    // dQ += dS K over this warpgroup's keys and the block's columns: K as an
    // MN-major B from row 64 w of box cg * DC / 64
    const uint32_t kq0 = smem_u32(ks + (cg * G::DC / DB) * BK * SPAN + 64 * w * SPAN);
    uint8_t* dsb = dss + w * G::DS_BYTES;
    float* stage_dq = reinterpret_cast<float*>(dqs + w * G::DQ_BYTES);

    float dk[G::DC / 2], dv[G::DC / 2];
#pragma unroll
    for (int i = 0; i < G::DC / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(&kv_full, 0);

    for (int it = 0; it < n_it; ++it) {
      const int m = a.nqt - 1 - it / GQ, h = hk * GQ + it % GQ;
      const int q0 = m * BQ;
      const int s = it % STAGES;
      uint32_t kw = kw0, vw = vw0, kq = kq0, qt = smem_u32(qs + s * G::Q_BYTES),
               ot = smem_u32(dos + s * G::Q_BYTES);
      asm volatile("" : "+r"(kw), "+r"(vw), "+r"(kq), "+r"(qt), "+r"(ot));
      mbar_wait(&full[s], (it / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T over D/16 k-slices, 32 B apart along a swizzled row
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk * 16 / DB, inb = (kk * 16 % DB) * 2;
        wgmma_ss(st, sdesc(kw + x * BK * SPAN + inb, 16, SBO), sdesc(qt + x * BQ * SPAN + inb, 16, SBO),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk * 16 / DB, inb = (kk * 16 % DB) * 2;
        wgmma_ss(dpt, sdesc(vw + x * BK * SPAN + inb, 16, SBO), sdesc(ot + x * BQ * SPAN + inb, 16, SBO),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = 2^(S^T c - lse log2 e), dS^T = P^T (dP^T - Delta); register i holds
      // key key0 + 8 ((i >> 1) & 1) and query q0 + 8 (i >> 2) + col + (i & 1).
      // Each 16-query slice is packed into its bf16 A fragments at once, so
      // its fp32 registers die before the next slice is computed.
      const float* lt = lses + s * BQ;
      const float* dt = dels + s * BQ;
      const bool edge = q0 + BQ > a.S || k0 + BK > a.T ||
                        (a.causal && k0 + 64 * w + 63 > q0 + off);
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kc + half;
          const float2 L = *reinterpret_cast<const float2*>(lt + 8 * j + col);
          const float2 Dl = *reinterpret_cast<const float2*>(dt + 8 * j + col);
          const float l2[2] = {L.x * LOG2E, L.y * LOG2E}, del[2] = {Dl.x, Dl.y};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 4 * j + r;
            float p = ex2(fmaf(st[i], c, -l2[r & 1]));
            if (edge) {
              const int key = key0 + (r & 2 ? 8 : 0);
              const int qry = q0 + 8 * j + col + (r & 1);
              if (key >= a.T || qry >= a.S || (a.causal && key > qry + off)) p = 0.f;
            }
            st[i] = p;
            dpt[i] = p * (dpt[i] - del[r & 1]);
          }
        }
        // the A fragment of query slice kc: rows g / g + 8, queries col.. and col + 8..
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kc][r] = pack_bf16(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
          dsf[kc][r] = pack_bf16(dpt[8 * kc + 2 * r], dpt[8 * kc + 2 * r + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q over the block's columns: dO and Q MN-major,
      // the next 64 columns a box (BQ * SPAN) on, the next 8 queries 1 KB
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs(dv, pf[kc], sdesc(ot + cg * BQ * SPAN + kc * 16 * SPAN, BQ * SPAN, SBO));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs(dk, dsf[kc], sdesc(qt + cg * BQ * SPAN + kc * 16 * SPAN, BQ * SPAN, SBO));
      wgmma_commit();

      // dS^T into this warpgroup's buffer, [key][query] with the 128-byte
      // swizzle: 16-byte chunk q of a key's row lands at chunk q ^ (key % 8).
      // The last tile's dQ product, which read it, is done (waited below).
      uint32_t dsa = smem_u32(dsb);
      asm volatile("" : "+r"(dsa));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = warp * 16 + lane / 4 + 8 * (r & 1);
          const int chunk = 2 * kc + (r >> 1);
          *reinterpret_cast<uint32_t*>(dsb + row * SPAN + ((chunk ^ (row & 7)) << 4) + col * 2) =
              dsf[kc][r];
        }
      fence_async_smem();
      named_sync(2 + w, 128);  // the warpgroup's dS^T is in place

      wgmma_wait_all();  // dV and dK are done: the stage's Q and dO are free
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);

      // dQ = dS K over this warpgroup's 64 keys: dS an MN-major A (queries
      // contiguous), K an MN-major B
      float dq[G::DC / 2];
#pragma unroll
      for (int i = 0; i < G::DC / 2; ++i) dq[i] = 0.f;
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        wgmma_ss_tt(dq, sdesc(dsa + kk * 16 * SPAN, BQ * SPAN, SBO),
                    sdesc(kq + kk * 16 * SPAN, BK * SPAN, SBO), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);

      // the tile into shared memory in register order, then one bulk add; the
      // two warpgroups add their keys' parts into the same tile
      if (tid == 0 && it > 0) bulk_wait_read();  // the last tile's add has read its stage
      named_sync(2 + w, 128);
#pragma unroll
      for (int r4 = 0; r4 < G::DC / 8; ++r4)
        *reinterpret_cast<float4*>(stage_dq + (r4 * 128 + tid) * 4) =
            make_float4(dq[4 * r4], dq[4 * r4 + 1], dq[4 * r4 + 2], dq[4 * r4 + 3]);
      fence_async_smem();
      named_sync(2 + w, 128);
      if (tid == 0)
        bulk_reduce_add(a.dq_acc + dq_tile(b, h, m, cg, a.Hq, a.nqt, G::NCG, BQ * G::DC),
                        stage_dq, G::DQ_BYTES);
    }
    if (tid == 0) bulk_wait_all();

    // dK (scaled) and dV, keys < T; register 4j + {0,1} holds key0, 4j + {2,3} key0 + 8
    __nv_bfloat16* dkb = a.dk + b * a.sdk[0] + hk * a.sdk[1];
    __nv_bfloat16* dvb = a.dv + b * a.sdv[0] + hk * a.sdv[1];
#pragma unroll
    for (int j = 0; j < G::DC / 8; ++j) {
      const int d = cg * G::DC + 8 * j + col;
      if (key0 < a.T) {
        *reinterpret_cast<uint32_t*>(dkb + key0 * a.sdk[2] + d) =
            pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + key0 * a.sdv[2] + d) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
      }
      if (key0 + 8 < a.T) {
        *reinterpret_cast<uint32_t*>(dkb + (key0 + 8) * a.sdk[2] + d) =
            pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + (key0 + 8) * a.sdv[2] + d) =
            pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

struct RowArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* olo;  // optional: o - bf16(o), laid out as o
  const __nv_bfloat16* g;    // dO
  float* delta;
  int Hq, S, D;
  long long ls, so[3], sg[3];
};

// delta[(b, h), s] = sum_d dO[b, h, s, d] (o + olo)[b, h, s, d] in fp32, 0 for
// S <= s < ls: a warp a row, 8 rows a block.
__global__ void __launch_bounds__(256) flash_bwd_delta(const RowArgs a) {
  const int bh = blockIdx.y;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= a.ls) return;
  float acc = 0.f;
  if (row < a.S) {
    const int b = bh / a.Hq, h = bh - b * a.Hq;
    const long long at = b * a.so[0] + h * a.so[1] + row * a.so[2];
    const __nv_bfloat16* gp = a.g + b * a.sg[0] + h * a.sg[1] + row * a.sg[2];
    for (int d = 2 * lane; d < a.D; d += 64) {
      float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.o + at + d));
      if (a.olo != nullptr) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.olo + at + d));
        x.x += r.x;
        x.y += r.y;
      }
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp + d));
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, d);
  }
  if (lane == 0) a.delta[(long long)bh * a.ls + row] = acc;
}

struct ConvertArgs {
  const float* dq_acc;
  __nv_bfloat16* dq;
  int Hq, S, nqt;
  float scale;
  long long sq[3];
  long long total;  // B * S * Hq * D / 2 column pairs
};

// dq[b, h, s, d] = scale * the fp32 sum, read from the tile and register
// order the main kernel's consumers stage it in; a thread a column pair.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq(const ConvertArgs a) {
  using G = Geo<D>;
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  if (t >= a.total) return;
  const int d = 2 * (int)(t % (D / 2));
  long long rest = t / (D / 2);
  const int h = (int)(rest % a.Hq);
  rest /= a.Hq;
  const int s = (int)(rest % a.S);
  const int b = (int)(rest / a.S);
  const int m = s / BQ, rr = s % BQ;
  const int cg = d / G::DC, cc = d % G::DC;
  // the accumulator fragment: row rr is warp rr/16's row g (or g + 8), column
  // cc is register 4 (cc/8) + (cc%2) of lane 4 g + (cc%8)/2
  const int warp = rr / 16, upper = (rr % 16) / 8, g = rr % 8;
  const int tid = warp * 32 + g * 4 + (cc % 8) / 2;
  const int r = 4 * (cc / 8) + 2 * upper;
  const float* tile = a.dq_acc + dq_tile(b, h, m, cg, a.Hq, a.nqt, G::NCG, BQ * G::DC);
  const float2 v = *reinterpret_cast<const float2*>(tile + ((r >> 2) * 128 + tid) * 4 + (r & 3));
  *reinterpret_cast<uint32_t*>(a.dq + b * a.sq[0] + h * a.sq[1] + s * a.sq[2] + d) =
      pack_bf16(v.x * a.scale, v.y * a.scale);
}

template <int D>
int launch(const void* const* ptrs, const long long* maps, Args& a, const RowArgs& ra,
           ConvertArgs& ca, int B, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return NO_ENTRY_POINT;
  CUtensorMap tmaps[4];
  for (int i = 0; i < 4; ++i) {
    const int rc = encode(fn, &tmaps[i], ptrs[i], maps + 10 * i, i == 1 || i == 2 ? BK : BQ, a.pos[i]);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_delta<<<dim3((unsigned)((a.ls + 7) / 8), B * a.Hq), 256, 0, stream>>>(ra);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 grid(B * a.Hkv * Geo<D>::NCG, (a.T + BK - 1) / BK);
  flash_bwd_sm90<D><<<grid, THREADS, Geo<D>::SMEM, stream>>>(tmaps[0], tmaps[1], tmaps[2], tmaps[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq<D><<<(unsigned)((ca.total + 255) / 256), 256, 0, stream>>>(ca);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of flash_attention_fwd_sm90.  q (B,Hq,S,D), k and v
// (B,Hkv,T,D), o and dO (B,Hq,S,D), all bf16, D in {64, 128, 192}; `olo`,
// when not null, o - bf16(o) from the forward, with o's strides.  `maps`
// holds 10 values for each of q, k, v and dO, as the forward's.  `lse`
// (fp32) is the forward's, row s of head (b, h) at lse[(b * Hq + h) * ls +
// s]; `delta` is fp32 scratch of the same layout; `dq_acc` fp32 scratch of
// B * Hq * ls * D zeros; ls a multiple of 4 and at least ceil(S/64) * 64.
// `strides` holds the element strides (batch, head, position) of o, dO,
// dq, dk and dv, each with its last dimension contiguous; dq is laid out as
// q, dk and dv as k and v.  Launches three kernels on `stream`; returns 0,
// the cudaError_t of the first launch that failed, or a code >= 100000
// when a tensor map cannot be made.  The caller checks what the kernels
// assume: Hq a multiple of Hkv, S <= T when causal.
int flash_attention_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                             const void* olo, const void* dO, const float* lse, float* delta, float* dq_acc,
                             void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int S, int T,
                             int D, long long ls, const long long* maps, const long long* strides,
                             int causal, void* stream) {
  const int nqt = (S + BQ - 1) / BQ;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T < 1 || ls % 4 != 0 ||
      ls < (long long)nqt * BQ)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  Args a;
  a.lse = lse; a.delta = delta; a.dq_acc = dq_acc;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.T = T; a.causal = causal; a.nqt = nqt; a.ls = ls;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  RowArgs ra;
  ra.o = static_cast<const __nv_bfloat16*>(o);
  ra.olo = static_cast<const __nv_bfloat16*>(olo);
  ra.g = static_cast<const __nv_bfloat16*>(dO);
  ra.delta = delta; ra.Hq = Hq; ra.S = S; ra.D = D; ra.ls = ls;
  ConvertArgs ca;
  ca.dq_acc = dq_acc;
  ca.dq = static_cast<__nv_bfloat16*>(dq);
  ca.Hq = Hq; ca.S = S; ca.nqt = nqt; ca.scale = scale;
  ca.total = (long long)B * S * Hq * (D / 2);
  for (int i = 0; i < 3; ++i) {
    ra.so[i] = strides[i];
    ra.sg[i] = strides[3 + i];
    ca.sq[i] = strides[6 + i];
    a.sdk[i] = strides[9 + i];
    a.sdv[i] = strides[12 + i];
  }
  const void* ptrs[4] = {q, k, v, dO};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64>(ptrs, maps, a, ra, ca, B, s);
    case 128: return launch<128>(ptrs, maps, a, ra, ca, B, s);
    case 192: return launch<192>(ptrs, maps, a, ra, ca, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the main kernel at head dim D takes (0
// for a D it does not take).
int flash_attention_bwd_sm90_smem_bytes(int D) {
  switch (D) {
    case 64: return Geo<64>::SMEM;
    case 128: return Geo<128>::SMEM;
    case 192: return Geo<192>::SMEM;
    default: return 0;
  }
}

const char* flash_attention_bwd_sm90_error_string(int code) {
  if (code >= NO_ENTRY_POINT) return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (code >= TMAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Flash-attention forward for Hopper (sm_90a) in bf16 on the tensor cores:
// wgmma products, TMA loads, warp-specialised producer and consumers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:79
// (flash_attention_bh, body _flash_kernel at :32) for bf16 inputs at head
// dims 64, 128 and 192: o = softmax(q k^T / sqrt(D), causal mask with
// q_offset = T - S) v, as an online softmax over key tiles with a running
// max m, a running sum l and an fp32 accumulator; masked scores are -1e30,
// key tiles wholly above the diagonal are skipped, and the result is
// acc / max(l, 1e-20), as in the TPU kernel.  fp32 inputs, and bf16 at D 16
// and 32, stay on the CUDA-core kernel in flash_attention.cu (the wrapper
// routes by dtype and D, never by failure): fp32 because TF32 tensor cores
// would miss the fp32 gate of 1e-5; D <= 32 because there a tile's products
// are one or two k16 steps and the time goes to the softmax, which is the
// same on both kernels.
//
// Bound: operations.  Causal attention does 2*B*Hq*S^2*D flops (q k^T and
// p v over the lower triangle) on B*(2*Hq*S + 2*Hkv*T)*D bf16 elements read
// or written once; at the LM path's q (4,32,4096,128), kv (4,8,4096,128)
// that is 5.50e11 flops on 335 MB: 0.556 ms at the 989 TFLOP/s bf16 peak
// against 0.100 ms at 3.35 TB/s.  So the design is about keeping the
// tensor cores fed, and the bytes are a sixth of the bound:
//  * Both products on the tensor cores, fp32 accumulate: S = Q K^T as
//    wgmma m64n{BK}k16 with Q and K read from shared memory (K-major), and
//    O += P V as wgmma m64n{D}k16 with P as the register A operand and V
//    read from shared memory as a transposed (MN-major) B.  The fp32 S
//    fragment of keys 16c..16c+15 (sc[8c..8c+7]: rows g and g+8, keys
//    2(lane%4)+{0,1} and +8) is exactly the A fragment of k-slice c, so P
//    never goes through shared memory.
//  * P is carried as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), and
//    P V is two products into one accumulator.  P rounded once to bf16 moves
//    an output row by about 2.3e-3 of its norm on average and 3.7e-3 at the
//    largest over 4096 rows (a CPU emulation of this tiling,
//    tests/test_torch_flash_attention.py), too near the 5e-3 row gate; the
//    split carries P to about 2^-16 and leaves only the output's bf16
//    rounding.  It costs half again the tensor-core work: at D = 128, 8
//    wgmma of Q K^T and 16 of P V a tile.
//  * The softmax works on the unscaled scores, so a score costs one FMA
//    and one ex2 (p = 2^(q.k c - m c), c = log2(e)/sqrt(D)); masks are
//    applied only on the tiles that need them.
//  * A block is three warpgroups: a producer and two consumers of 64 q rows
//    each (BQ = 128).  One thread of the producer issues every TMA load:
//    the Q tile once, then K and V tiles of BK keys through a ring of two
//    stages, each behind one "full" mbarrier (TMA's transaction count) and
//    one "empty" mbarrier (lane 0 of each consumer warp arrives when its
//    products have read the stage).  Loads run a tile ahead of the
//    products; the two consumers share each K and V tile, and while one
//    runs its softmax the other's products can use the tensor cores.
//    setmaxnreg hands the producer's registers to the consumers (24 and 240
//    a thread); a consumer holds S (BK/2 fp32), O (D/2) and P's two parts
//    (BK/2 32-bit registers), and ptxas fits it with no spills.  (Making
//    the two consumers take turns with named barriers, or issuing the next
//    tile's Q K^T before this tile's P V is done, cost time or spilled.)
//  * Shared memory: TMA writes each tile with the 128-byte swizzle (a box
//    is 64 bf16 columns by the tile's rows, so a row of D = 128 loads as
//    two boxes), tiles start on 1024 bytes where the pattern repeats, and
//    every wgmma descriptor names the same layout: K-major with 8-row groups
//    1024 B apart, a k16 step 32 B along the swizzled row; V MN-major with
//    the next 64 columns one box further (LBO) and the next 8 keys 1024 B
//    (SBO).  At D = 128 (BK = 128): Q 32 KB + 2 stages x (K 32 + V 32 KB) =
//    160 KB.  At D = 192, BK = 64: Q 48 KB + 2 x (24 + 24 KB) = 144 KB (128
//    keys would need 240 KB, over the 227 KB a block may have).
//  * Causal: key tiles wholly above the diagonal are never loaded.
//
// Where it departs from the TPU's grid (BQ = BK = 128, a sequential kv axis
// revisiting one output block in VMEM):
//  * One block per (batch*head, 128-row q tile); the block loops over key
//    tiles itself.  The q tile is the slow grid axis, run from the last
//    tile down: the heaviest causal tiles of every head go first and the
//    light ones fill the tail.
//  * The TPU wrapper's padding and GQA repeat are gone: tensor maps are
//    built on the host over the views' own strides (the model's (B,S,H,D)
//    projections are read in place), GQA is a TMA coordinate (kv head
//    h / (Hq/Hkv)), TMA fills rows past S or T with zeros, rows >= S are not
//    stored, and keys >= T still score -inf (a zero key would score 0).
//  * cuTensorMapEncodeTiled is a driver function; it is fetched with
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// The kernel runs on the caller's stream and allocates nothing; the C entry
// point returns cudaGetLastError() after the launch.
#include <cuda.h>  // CUtensorMap and its enums: types only, no driver library linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 128;        // q rows a block: two consumer warpgroups of 64
constexpr int STAGES = 2;      // K/V ring depth
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SPAN = 128;      // bytes of a swizzled box row: 64 bf16
constexpr int DB = SPAN / 2;   // columns a box
constexpr int SW128 = 1;       // wgmma descriptor layout type of the 128-byte swizzle
constexpr int TMAP_ERROR = 100000;     // + CUresult: the driver refused a tensor map
constexpr int NO_ENTRY_POINT = 200000; // cuTensorMapEncodeTiled not found

template <int D>
struct Geo {
  static constexpr int BK = D > 128 ? 64 : 128;  // keys a tile
  static constexpr int NBOX = D / DB;             // boxes across a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment slack
  static_assert(D % DB == 0, "D must be a multiple of 64");
  static_assert(SMEM <= 232448, "over the 227 KB a block may have");
};

struct Args {
  __nv_bfloat16* o;
  int Hq, Hkv, S, T, causal;
  float scale_log2;       // 1/sqrt(D) (rounded once, as the TPU kernel's) * log2(e)
  long long so[3];        // element strides of o's (batch, head, position)
  signed char pos[3][3];  // q, k, v: the map dimension (of the outer three) of rows, heads, batch
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed (a fresh
// barrier counts its phase of parity 1 as completed).  A wait of more than
// 2^33 clocks (seconds) can only be a fault of the ring: it traps, so the
// launch fails at the next synchronisation instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1LL << 33)) __trap();
}

// One box of a 4-D tensor map (D, then rows, heads and batch in the order
// pos gives) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         const signed char* pos, int row, int head, int batch) {
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = pos[0] == i ? row : pos[1] == i ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units), the 128-byte swizzle in bits 62-63.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)SW128 << 62);
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across the points where it starts and ends.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(d[i][r])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, smem, K-major) * B (64 x 16, smem, K-major)^T;
// overwrites d when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) (+)= A (64 x 16, smem, K-major) * B (128 x 16, smem, K-major)^T;
// overwrites d when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major: transpose-B)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major: transpose-B)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192, fp32) += A (64 x 16, registers) * B (16 x 192, smem, MN-major: transpose-B)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Args a) {
  using G = Geo<D>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  // tiles start on 1024 B, where the 128-byte swizzle pattern repeats
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* kv = qs + G::Q_BYTES;  // stage s: K at kv + 2s * KV_BYTES, V after it

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const int off = a.causal ? a.T - a.S : 0;
  // keys the tile's last row can see under the causal mask: 0 .. q0+BQ-1+off
  const int kv_end = a.causal ? min(a.T, q0 + BQ + off) : a.T;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
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
    // ---- producer: one thread keeps the K/V ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(&q_full, G::Q_BYTES);
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x)
        tma_load(qs + x * BQ * SPAN, &qmap, &q_full, x * DB, a.pos[0], q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);  // consumers are done
        uint8_t* ks = kv + 2 * s * G::KV_BYTES;
        uint8_t* vs = ks + G::KV_BYTES;
        mbar_expect_tx(&full[s], 2 * G::KV_BYTES);
#pragma unroll
        for (int x = 0; x < G::NBOX; ++x)
          tma_load(ks + x * BK * SPAN, &kmap, &full[s], x * DB, a.pos[1], t * BK, hk, b);
#pragma unroll
        for (int x = 0; x < G::NBOX; ++x)
          tma_load(vs + x * BK * SPAN, &vmap, &full[s], x * DB, a.pos[2], t * BK, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 q rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int wrow = q0 + group * 64;              // the warpgroup's first row
    const int row0 = wrow + warp * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col = 2 * (lane % 4);                // its first column of every 8
    const uint8_t* qw = qs + group * 64 * SPAN;
    constexpr uint32_t SBO = 8 * SPAN;             // 8 rows: one swizzle atom

    float o[D / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only
    mbar_wait(&q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint8_t* ks = kv + 2 * s * G::KV_BYTES;
      const uint8_t* vs = ks + G::KV_BYTES;
      const int k0 = t * BK;
      mbar_wait(&full[s], (t / STAGES) & 1);

      // S = Q K^T: D/16 k-slices; a slice is 32 B further along a swizzled row
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk * 16 / DB, inb = (kk * 16 % DB) * 2;
        wgmma_ss(sc, desc(qw + x * BQ * SPAN + inb, 16, SBO), desc(ks + x * BK * SPAN + inb, 16, SBO),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask only where the tile crosses the diagonal or T
      if (k0 + BK > a.T || (a.causal && k0 + BK - 1 > wrow + off)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + col + (i & 1);
          const int qpos = (i & 2 ? row0 + 8 : row0) + off;
          if (key >= a.T) {
            sc[i] = -INFINITY;  // past the keys: weight exactly 0
          } else if (a.causal && key > qpos) {
            sc[i] = NEG;
          }
        }
      }

      // online softmax on the unscaled scores: m is a row's largest q.k and
      // p = 2^(q.k c - m c) with c = log2(e)/sqrt(D), one FMA and one ex2.  A
      // row's first tile always holds an unmasked key (key 0: causal needs
      // S <= T), so m is a real score after it and a masked score's p is 0.
      // A row's BK scores are spread over the 4 lanes of a quad.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
      }
      const float c = a.scale_log2;
      const float alpha0 = ex2((m0 - mx0) * c), alpha1 = ex2((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = m0 * c, mc1 = m1 * c;
      // P as the A fragments of the BK/16 k-slices, in two bf16 parts
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: row g (0, 2) or g + 8 (1, 3); keys 2q (0, 1) or 2q+8
          const float mc = r & 1 ? mc1 : mc0;
          const float e0 = ex2(fmaf(sc[8 * kc + 2 * r], c, -mc));
          const float e1 = ex2(fmaf(sc[8 * kc + 2 * r + 1], c, -mc));
          (r & 1 ? ps1 : ps0) += e0 + e1;
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(e0, e1);
          const float2 hf = __bfloat1622float2(h2);
          hi[kc][r] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[kc][r] = pack_bf16(e0 - hf.x, e1 - hf.y);
        }
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }

      // O += P V over BK/16 k-slices of 16 keys, each twice (hi, lo); V is
      // MN-major: the next 64 columns a box (BK * SPAN) on, the next 8 keys 1 KB
      fence_regs(o);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint64_t dv = desc(vs + kc * 16 * SPAN, BK * SPAN, SBO);
        wgmma_rs(o, hi[kc], dv);
        wgmma_rs(o, lo[kc], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(hi);  // the A registers stay put until the products are done
      fence_regs(lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp no longer reads the stage
    }

#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, d);
      l1 += __shfl_xor_sync(0xffffffffu, l1, d);
    }
    const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
    __nv_bfloat16* ob = a.o + b * a.so[0] + h * a.so[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row0 < a.S)
        *reinterpret_cast<uint32_t*>(ob + row0 * a.so[2] + 8 * j + col) =
            pack_bf16(o[4 * j] / den0, o[4 * j + 1] / den0);
      if (row0 + 8 < a.S)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * a.so[2] + 8 * j + col) =
            pack_bf16(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a bf16 (B,H,L,D) view.  g: the map's dimensions (D, then
// rows, heads and batch in the wrapper's stride order), its 3 outer byte
// strides and the places of rows, heads and batch among the outer three.
// A box is 64 columns by `rows` rows, with the 128-byte swizzle.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* g, int rows,
           signed char* pos) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4] = {(cuuint32_t)DB, 1, 1, 1}, elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)g[i];
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)g[4 + i];
    pos[i] = (signed char)g[7 + i];
  }
  box[1 + pos[0]] = (cuuint32_t)rows;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)r;
}

template <int D>
int launch(const void* const* ptrs, const long long* maps, Args& a, int B, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return NO_ENTRY_POINT;
  CUtensorMap tmaps[3];
  for (int i = 0; i < 3; ++i) {
    const int rc = encode(fn, &tmaps[i], ptrs[i], maps + 10 * i, i == 0 ? BQ : Geo<D>::BK, a.pos[i]);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.Hq, (a.S + BQ - 1) / BQ);
  flash_fwd_sm90<D><<<grid, THREADS, Geo<D>::SMEM, stream>>>(tmaps[0], tmaps[1], tmaps[2], a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,S,D), k and v (B,Hkv,T,D) bf16, D in {64, 128, 192}.  `maps` holds
// 10 values for each of q, k, v: the tensor map's 4 dimensions (D first), 3
// byte strides and the places of rows, heads and batch among its outer
// dimensions (the wrapper orders them by stride; strides are multiples of
// 16 and bases 16-byte aligned).  `ostrides` are o's element strides
// (batch, head, position), o bf16 (B,Hq,S,D) with the last dimension
// contiguous.  Launches on `stream`; returns 0, the cudaError_t of the
// launch, or a code >= 100000 when a tensor map cannot be made.  The caller
// checks what the kernel assumes: Hq a multiple of Hkv, S <= T when causal,
// ceil(S/128) <= 65535.
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                             int Hkv, int S, int T, int D, const long long* maps,
                             const long long* ostrides, int causal, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.T = T; a.causal = causal;
  a.scale_log2 = (float)(1.0 / sqrt((double)D)) * 1.4426950408889634f;
  for (int i = 0; i < 3; ++i) a.so[i] = ostrides[i];
  const void* ptrs[3] = {q, k, v};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64>(ptrs, maps, a, B, s);
    case 128: return launch<128>(ptrs, maps, a, B, s);
    case 192: return launch<192>(ptrs, maps, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the kernel at head dim D takes (0 for a
// D it does not take).
int flash_attention_sm90_smem_bytes(int D) {
  switch (D) {
    case 64: return Geo<64>::SMEM;
    case 128: return Geo<128>::SMEM;
    case 192: return Geo<192>::SMEM;
    default: return 0;
  }
}

const char* flash_attention_sm90_error_string(int code) {
  if (code >= NO_ENTRY_POINT) return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (code >= TMAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// The bf16 flash-attention forward for Hopper (sm_90a): one kernel template,
// flash_fwd_tma_wgmma, for K1 (flash_attn_fwd.cu) and for the attention
// probes (attn_probes.cu), which are compile-time variants of its loop.
//
// Replaces the Pallas TPU kernels `_fwd_kernel_oneshot` and `_fwd_kernel`
// (orbit2_tpu/ops/flash_attention.py:117, :150; launched at :214, :247):
// o = softmax(q k^T * scale) v with fp32 accumulation and an online softmax
// in base 2, plus the base-2 logsumexp lse = m + log2(l) per query row,
// fp32 [B*H, N_q]. Non-causal; kv columns past N_k get p = 0.
//
// What bounds it on the H100: 4 B H N_q N_k D flops on the tensor cores
// against reading q, k, v and writing o once (137.4 GFLOP against 134 MB at
// (B8, N2048, H16, d64): 0.139 ms at 989 TFLOP/s, 0.040 ms at 3.35 TB/s), so
// the matrix units; with dropout also the Philox bits, one 10-round call per
// 8 scores on the integer pipes (67.1 M calls at that shape).
//
// Design. A block owns one (batch*head, 128-query tile) and has three
// warpgroups:
//   * a producer warpgroup (40 registers a thread after setmaxnreg), of which
//     one thread issues TMA loads: the q tile once, then the k and v tiles of
//     each kv step into a ring of kStages stages guarded by full/empty
//     mbarriers, so loads run ahead of the products. The TMA maps describe
//     q, k and v as 4-D (D, H, N, B) tensors with their own strides, so the
//     views of the packed qkv projection need no copy, and rows past N come
//     in as zeros. Every tile is stored as 64-column slabs of 128-byte rows
//     in the 128-byte swizzle, the layout wgmma reads free of bank conflicts.
//   * two consumer warpgroups (232 registers a thread), 64 query rows each.
//     s = q k^T is wgmma m64n{BK}k16 with q and k (K-major) read from shared
//     memory; the online softmax (and the dropout) run on s in registers; the
//     fp32 accumulator layout of s, packed to bf16, is the A-register layout
//     of o += p v, a wgmma m64n{D}k16 with p in registers and v read
//     row-major through the transposed-B descriptor. p never touches shared
//     memory and no tile is transposed. Each tile's q k^T is issued beside
//     the previous tile's p v, so the softmax of one tile runs while the
//     tensor cores work on the other's value product.
//   * dropout bits are K4's (kernel_prng.cuh) at (seed, stream = b H + h,
//     query row, key column / 8), generated in the accumulator layout: the 4
//     lanes of a row quad hold the 8 columns of one Philox call in rows g
//     and g + 8, so each lane draws one of the quad's calls for half of the
//     column groups, and two shuffles of packed drop flags hand every lane
//     its own (drop_bits: one call per 8 scores, no keep tile, no barrier).
//     The bits do not depend on the scores, so they are drawn while the
//     products run.
//
// Measured (PERF.md, chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): at
// (B8, N2048, H16, d64) about 0.41 ms without dropout, level with SDPA's
// flash forward, and about 0.68 ms with dropout, where the Philox calls
// (~8 integer instructions a dropped element, over the SM's FMA and ALU
// pipes) take ~0.27 ms.
//
// Tiles and budgets (227 KB of shared memory and 64 K registers an SM; one
// block an SM):
//   D  BK  stages  shared memory (q + stages x (k + v))   consumer registers
//   64 128  4      16 + 4 x 32 = 144 KB                   s 64, o 32, p 32
//  128 128  2      32 + 2 x 64 = 160 KB                   s 64, o 64, p 32
//  256  64  2      64 + 2 x 64 = 192 KB                   s 32, o 128, p 16
// with 40 x 128 + 232 x 256 = 64,512 registers a block.
//
// The probes (scripts/bench_attn2.py's S1a-c, S2) are Variant values: what
// happens to s between the two products, and for S1c a first sweep of
// q k^T alone for the row max. They share every load, barrier and product.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time

#include "flash_common.cuh"

namespace orbit2 {
namespace hopper {

constexpr int kConsumers = 2;                     // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kConsumers;          // query rows of a block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kSlab = 64;                         // bf16 columns of a 128-byte row
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D>
struct Tiles {
  static constexpr int kBlockK = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kSlabs = D / kSlab;
  static constexpr uint32_t kQBytes = kBlockQ * D * 2;
  static constexpr uint32_t kKBytes = kBlockK * D * 2;  // a k tile, and a v tile
  static constexpr uint32_t kStageBytes = 2 * kKBytes;
  static constexpr uint32_t kBarriers = kQBytes + kStages * kStageBytes;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr size_t kSmemBytes = 1024 + kBarriers + 8 * (2 * kStages + 1);
};

// What happens to s between the two products.
enum Variant {
  kFlash,        // K1: online softmax of s * scale (and dropout); o /= l, lse
  kMatmulOnly,   // S1a: p = s
  kExpNoReduce,  // S1b: p = exp2(s - 20)
  kFullSoftmax,  // S1c: a first sweep for m = rowmax(s); p = exp2(s - m); o /= rowsum(p)
  kBoundShift,   // S2: p = bf16(exp2(s - bound)); o /= rowsum(p)
};

struct Params {
  bf16* o;             // [B, N_q, H, D] contiguous
  float* lse;          // [B*H, N_q] (kFlash)
  const float* bound;  // [B*H, N_q] (kBoundShift)
  int heads, n_q, n_k;
  float scale_log2;    // kFlash: the softmax scale times log2(e)
  Dropout drop;        // kFlash with kDropout
};

// ---- shared memory, mbarriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of TMA traffic in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map at coordinates (c0 innermost .. c3) into shared memory;
// its bytes count against the barrier's expected traffic.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// Descriptor of a shared-memory operand in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units in the descriptor).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes,
                                              uint32_t stride_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from touching `r` across an asynchronous wgmma: reads and
// writes of r after this point depend on it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a b^T for 64 rows: a [64, 16] and b [N, 16], both K-major in shared
// memory. d is the m64nN fp32 accumulator: d[4i + 2h + c] is row
// 16 warp + lane / 4 + 8h, column 8i + 2 (lane % 4) + c.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "score tile width");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d += a b for 64 rows: a [64, 16] bf16 in registers (the m16n8k16 A
// fragments of each warp's 16 rows), b [16, N] row-major (N contiguous) in
// shared memory, read through the transposed-B descriptor.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "head dim");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

// ---- the consumers' pieces ----------------------------------------------------------

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// 2^x on the special-function unit (one MUFU.EX2; 2^-inf = 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issues s = q k^T as one commit group, for one warpgroup's 64 query rows
// (q_rows: their rows of the q tile's first slab) against the BK keys of
// the k tile at k_smem; both are 64-column slabs, K-major, 8-row groups
// 1024 bytes apart.
template <int D, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint32_t q_rows,
                                             uint32_t k_smem) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t slab = kk / 4;
    const uint32_t off = (kk % 4) * 32;  // 16 columns into the 128-byte row
    const uint64_t da = smem_desc(q_rows + slab * kBlockQ * 128 + off, 16, 1024);
    const uint64_t db = smem_desc(k_smem + slab * BK * 128 + off, 16, 1024);
    wgmma_ss<BK>(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// Issues acc += p v as one commit group: p's score column groups 2kk, 2kk + 1
// are the A fragment of kv step kk; the v tile at v_smem is 64-column slabs
// BK * 128 bytes apart, 8-row groups 1024 bytes apart.
template <int D, int BK>
__device__ __forceinline__ void issue_values(float (&acc)[D / 2], const uint32_t (&p)[BK / 16][4],
                                             uint32_t v_smem) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<D>(acc, p[kk], smem_desc(v_smem + kk * 16 * 128, BK * 128, 1024), 1);
  }
  wgmma_commit();
}

// p rounded to bf16 pairs in the A-fragment layout of the value product.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// Sets the scores of kv columns k0 + c >= n_k (TMA's zero rows) to `fill`.
template <int BK>
__device__ __forceinline__ void mask_tail(float (&s)[BK / 2], int k0, int n_k, int t, float fill) {
  if (k0 + BK > n_k) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= n_k) s[i] = fill;
    }
  }
}

// One exchange of a transpose of drop flags across lanes: the lane-index bit
// kLaneXor trades places with bit log2(kShift) of the flags' positions.
// `upper` is this lane's bit. The lane keeps its flags whose position bit
// equals it, and takes from the partner lane the flags for it, rotated onto
// the positions it does not keep: afterwards that position bit names the
// lane a flag came from and the lane bit the lane it is for. One shuffle, a
// rotate and a bit select.
template <int kLaneXor, int kShift>
__device__ __forceinline__ uint32_t trade_flags(uint32_t mine, bool upper) {
  constexpr uint32_t kLow = kShift == 1 ? 0x55555555u : kShift == 2 ? 0x33333333u : 0x0F0F0F0Fu;
  static_assert(kShift == 1 || kShift == 2 || kShift == 4, "flag positions are bytes");
  const uint32_t keep = upper ? ~kLow : kLow;
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, kLaneXor);
  const uint32_t moved = __funnelshift_l(other, other, upper ? 32 - kShift : kShift);
  return (mine & keep) | (moved & ~keep);
}

// The dropout's drop flags of rows q_row, q_row + 8 and kv columns k0 .. +BK
// of this thread's accumulator elements: element e is dropped when bit e % 32
// of dropped[e / 32] is set, a shift known at compile time. They are K4's
// bits: a Philox call covers the 8 columns of one column group c (8c ..
// 8c + 7) in one row, word t of it this lane's two columns, so the 4 lanes
// of a row quad share the 2 calls (rows q_row, q_row + 8) of each group.
// Lane t draws the calls of row q_row + 8 (t & 1) for the groups of parity
// t >> 1 (BK / 16 calls, 8 flags each, packed 4 calls a word), and two
// exchanges (lanes 1 and 2 apart) transpose the flags so each lane holds its
// own. They do not depend on the scores, so they are drawn while the
// products run.
template <int BK>
__device__ __forceinline__ void drop_bits(uint32_t (&dropped)[BK / 64], int q_row, int k0, int t,
                                          int bh, const Dropout& drop) {
  const uint32_t row = (uint32_t)(q_row + 8 * (t & 1));
  const uint32_t col8 = (uint32_t)(k0 / 8 + (t >> 1));
  const uint32_t addend = drop_addend(drop.threshold);
#pragma unroll
  for (int w = 0; w < BK / 64; ++w) {
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 3; k >= 0; --k) {  // call k of the word: column group 2 (4 w + k) + (t >> 1)
      acc = shift_in_drop8(acc, dropout_bits8(drop.seed, (uint32_t)bh, row, col8 + 8 * w + 2 * k),
                           addend);
    }
    acc = trade_flags<1, 2>(acc, t & 1);  // the row half, for bit 0 of the word index
    dropped[w] = trade_flags<2, 4>(acc, t & 2);  // the group parity, for bit 1
  }
}

// Multiplies s by the dropout's {0, 1/keep} of `dropped` (drop_bits).
template <int BK>
__device__ __forceinline__ void drop_scores(float (&s)[BK / 2], const uint32_t (&dropped)[BK / 64],
                                            float scale) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) s[e] *= ((dropped[e / 32] >> (e % 32)) & 1u) ? 0.f : scale;
}

// The variant's work between the two products, in place: s (the scores of
// kv columns k0 ..) becomes the p of the value product. kFlash folds the
// tile into the running max m and this thread's part of the row sums l,
// sets alpha, the factor the accumulator must be rescaled by, and drops by
// `dropped` after the normalizer (kDropout); the probes
// subtract `shift` (S1b's 20, S1c's row max, S2's bound) and sum p into l.
template <int BK, int kVariant, bool kDropout>
__device__ __forceinline__ void probabilities(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], const float (&shift)[2],
                                              const uint32_t (&dropped)[BK / 64], int k0, int t,
                                              const Params& prm) {
  if constexpr (kVariant == kFlash) {
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] *= prm.scale_log2;
    mask_tail<BK>(s, k0, prm.n_k, t, -INFINITY);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) m_tile[(e >> 1) & 1] = fmaxf(m_tile[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 4 threads are lanes 4g..4g+3
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m[r], m_tile[r]);  // finite: every tile has a valid column
      alpha[r] = exp2_fast(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      s[e] = exp2_fast(s[e] - m[(e >> 1) & 1]);
      l[(e >> 1) & 1] += s[e];  // the normalizer sums the undropped p
    }
    if constexpr (kDropout) drop_scores<BK>(s, dropped, prm.drop.scale);
  } else if constexpr (kVariant == kMatmulOnly) {
    mask_tail<BK>(s, k0, prm.n_k, t, 0.f);
  } else {
    mask_tail<BK>(s, k0, prm.n_k, t, -INFINITY);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      float p = exp2_fast(s[e] - shift[(e >> 1) & 1]);
      // S2 sums the bf16 p that goes into the product (the ones column);
      // S1c sums the fp32 p
      if constexpr (kVariant == kBoundShift) p = __bfloat162float(__float2bfloat16_rn(p));
      if constexpr (kVariant != kExpNoReduce) l[(e >> 1) & 1] += p;
      s[e] = p;
    }
  }
}

// ---- the kernel ------------------------------------------------------------------

template <int D, int kVariant, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tma_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const Params prm) {
  using T = Tiles<D>;
  constexpr int BK = T::kBlockK;
  constexpr int S = T::kStages;
  constexpr bool kTwoSweeps = kVariant == kFullSoftmax;
  static_assert(!kDropout || kVariant == kFlash, "dropout is K1's");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t stages = q_smem + T::kQBytes;  // stage s: k slabs, then v slabs
  const uint32_t full = q_smem + T::kBarriers;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * S;          // empty[s] = empty + 8 s
  const uint32_t q_full = empty + 8 * S;

  const int bh = blockIdx.y;
  const int b = bh / prm.heads;
  const int h = bh % prm.heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_tiles = (prm.n_k + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, 128 * kConsumers);  // every consumer thread
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int j = 0; j < T::kSlabs; ++j)
        tma_load(q_smem + j * kBlockQ * 128, &q_map, q_full, j * kSlab, h, q0, b);
      const int loads = kTwoSweeps ? 2 * n_tiles : n_tiles;
      for (int i = 0; i < loads; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);  // the first S pass at once
        const int k0 = (i % n_tiles) * BK;
        const bool with_v = !kTwoSweeps || i >= n_tiles;  // S1c's first sweep reads k only
        const uint32_t k_smem = stages + s * T::kStageBytes;
        mbar_expect_tx(full + 8 * s, with_v ? T::kStageBytes : T::kKBytes);
#pragma unroll
        for (int j = 0; j < T::kSlabs; ++j)
          tma_load(k_smem + j * BK * 128, &k_map, full + 8 * s, j * kSlab, h, k0, b);
        if (with_v) {
#pragma unroll
          for (int j = 0; j < T::kSlabs; ++j)
            tma_load(k_smem + T::kKBytes + j * BK * 128, &v_map, full + 8 * s, j * kSlab, h, k0,
                     b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // accumulator row (and row + 8) within the warp
    const int t = lane & 3;   // accumulator column pair
    const int row0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;  // within the q tile
    const uint32_t q_rows = q_smem + wg * 64 * 128;  // this warpgroup's rows of slab 0
    auto stage = [&](int i) { return stages + (i % S) * T::kStageBytes; };
    auto wait_full = [&](int i) { mbar_wait(full + 8 * (i % S), (i / S) & 1); };

    float s[BK / 2];
    float acc[D / 2];
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // kFlash: running row max (scaled)
    float l[2] = {0.f, 0.f};              // this thread's part of the row sums
    float alpha[2];
    uint32_t dropped[BK / 64];  // kDropout: the tile's drop flags (drop_bits)
    // what exp2 subtracts in the probes: S1b's fixed 20, S2's bound, S1c's row max
    float shift[2] = {20.f, 20.f};
    if constexpr (kVariant == kBoundShift) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + row0 + 8 * r;
        shift[r] = qi < prm.n_q ? prm.bound[(int64_t)bh * prm.n_q + qi] : 0.f;
      }
    }

    mbar_wait(q_full, 0);
    int i = 0;  // loads consumed: the ring's position
    if constexpr (kTwoSweeps) {
      shift[0] = shift[1] = -INFINITY;
      for (; i < n_tiles; ++i) {
        wait_full(i);
        fence_regs(s);
        wgmma_fence();
        issue_scores<D, BK>(s, q_rows, stage(i));
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(empty + 8 * (i % S));
        mask_tail<BK>(s, i * BK, prm.n_k, t, -INFINITY);
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) shift[(e >> 1) & 1] = fmaxf(shift[(e >> 1) & 1], s[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row's 4 threads are lanes 4g..4g+3
        shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 1));
        shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 2));
      }
    }

    // the first tile: its scores, then its p
    wait_full(i);
    fence_regs(s);
    wgmma_fence();
    issue_scores<D, BK>(s, q_rows, stage(i));
    if constexpr (kDropout) drop_bits<BK>(dropped, q0 + row0, 0, t, bh, prm.drop);
    wgmma_wait<0>();
    fence_regs(s);
    probabilities<BK, kVariant, kDropout>(s, m, l, alpha, shift, dropped, 0, t, prm);
    pack_p<BK>(p, s);
    // then each tile's scores and p run beside the previous tile's value
    // product on the tensor cores
    for (int it = 1; it < n_tiles; ++it, ++i) {
      wait_full(i + 1);
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      issue_scores<D, BK>(s, q_rows, stage(i + 1));
      issue_values<D, BK>(acc, p, stage(i) + T::kKBytes);
      if constexpr (kDropout) drop_bits<BK>(dropped, q0 + row0, it * BK, t, bh, prm.drop);
      wgmma_wait<1>();  // the scores; the value product may still run
      fence_regs(s);
      probabilities<BK, kVariant, kDropout>(s, m, l, alpha, shift, dropped, it * BK, t, prm);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * (i % S));
      if constexpr (kVariant == kFlash) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
      }
      pack_p<BK>(p, s);
    }
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    issue_values<D, BK>(acc, p, stage(i) + T::kKBytes);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * (i % S));

    // ---- epilogue ----
    constexpr bool kNormalize =
        kVariant == kFlash || kVariant == kFullSoftmax || kVariant == kBoundShift;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kNormalize) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int qi = q0 + row0 + 8 * r;
      if (qi < prm.n_q) {
        bf16* orow = prm.o + (((int64_t)b * prm.n_q + qi) * prm.heads + h) * D + 2 * t;
        if constexpr (kVariant == kFlash) {
          const float inv_l = 1.f / l[r];
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16x2(acc[4 * j + 2 * r] * inv_l, acc[4 * j + 2 * r + 1] * inv_l);
          }
          if (t == 0) prm.lse[(int64_t)bh * prm.n_q + qi] = m[r] + log2f(l[r]);
        } else {
          const float den = kNormalize ? l[r] : 1.f;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16x2(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
          }
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// What the entry points return when the driver refuses a tensor map.
constexpr int kEncodeFailed = -2;

// The TMA map of one [B, N, H, D] bf16 operand at `base`, with element
// strides {b, n, h} (the last dim contiguous): dims (D, H, N, B), boxes of
// `rows` x 64 in the 128-byte swizzle. TMA takes a 16-byte-aligned base and
// byte strides that are multiples of 16 (the wrapper copies an operand that
// breaks this); rows past N read as zeros.
inline bool encode_map(CUtensorMap* map, const void* base, int64_t d, int64_t heads, int64_t n,
                       int64_t batch, const int64_t* strides, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSlab, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encodes the maps of q, k, v (element strides {b, n, h} each) and launches
// the variant over B*H x ceil(N_q / 128) blocks. Returns 0, a cudaError_t
// code, or kEncodeFailed.
template <int D, int kVariant, bool kDropout>
int launch(const void* q, const void* k, const void* v, const int64_t* strides, int64_t batch,
           const Params& prm, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (!encode_map(&maps[i], bases[i], D, prm.heads, i == 0 ? prm.n_q : prm.n_k, batch,
                    strides + 3 * i, i == 0 ? kBlockQ : Tiles<D>::kBlockK))
      return kEncodeFailed;
  }
  const auto kernel = flash_fwd_tma_wgmma<D, kVariant, kDropout>;
  // at every launch: the limit belongs to the function in the current device's context
  const cudaError_t allowed = allow_smem(kernel, Tiles<D>::kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((prm.n_q + kBlockQ - 1) / kBlockQ), (unsigned)(batch * prm.heads));
  kernel<<<grid, kThreads, Tiles<D>::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], prm);
  return (int)cudaGetLastError();
}

}  // namespace hopper
}  // namespace orbit2

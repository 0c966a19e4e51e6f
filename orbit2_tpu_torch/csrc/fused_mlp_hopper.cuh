// The bf16 fused MLP for Hopper (sm_90a): its forward, K6a, and its backward,
// K6b (dx) and K6c (dW1, db1, dW2, db2), of fused_mlp.cu, as TMA-fed,
// warp-specialised wgmma kernels that compute every product once.
//
// Replaces, for bf16, the Pallas TPU kernels `_fwd_kernel`, `_dx_kernel` and
// `_dw_kernel` (orbit2_tpu/ops/fused_mlp.py:125, :177, :209; called at :154,
// :363, :386). With x [T, D], W1 [F, D], W2 [D2, F] (PyTorch's Linear
// layout), the output gradient do [T, D2] and the masks m1 [T, F], m2 [T, D2]
// (1 at rate 0):
//
//   F1        h_r = bf16(gelu(x W1^T + b1) m1)  into a bf16 [T, F] workspace
//   F2        out = bf16((h_r W2^T + b2) m2)    b2 and m2 in fp32, one rounding
//   stage H   h_pre = x W1^T + b1, dh = do2 W2, with do2 = bf16(do m2);
//             h_r = bf16(gelu(h_pre) m1), dpre = dh m1 gelu'(h_pre),
//             dpre_r = bf16(dpre); db1's partials = the column sums of dpre
//             (fp32, unrounded) over each 128-token tile
//   db2       partials = the column sums of do m2 (fp32, unrounded) over
//             each 64-token slice (mlp_bias2_partials)
//   dx        = dpre_r W1                       [T, F] x [F, D]
//   dW1       = dpre_r^T x,  dW2 = do2^T h_r    sums over T
//   db1, db2  = their partials summed over T in order
//
// The rounding points are the TPU kernels' (fp32 accumulation, h rounded to
// bf16 before the second product, :136-147) and those of
// ops/fused_mlp.py::fused_mlp_reference and fused_mlp_bwd_reference. do2 is
// made before stage H by the fused dropout (K5, fused_dropout.cu), which
// draws m2's bits and rounds the product once, as this backward's products
// need it; at rate 0 do2 is do. GELU (and its derivative) come from one
// exponential (normal_cdf: the TPU kernel's Abramowitz-Stegun erf), so F1's
// h_r and stage H's are the same function of the same accumulator.
//
// The workspace. The forward writes h_r once, a bf16 [T, F] tensor (32 MB
// at [4096, 1024 -> 4096 -> 1024]) that lives only for the call: the TPU
// kernel keeps the hidden in 16 MB of VMEM beside an fp32 [512, D2]
// accumulator, but an H100 SM has 256 KB of registers and 227 KB of shared
// memory, so a kernel that kept h on chip would recompute x W1^T for every
// output tile (2.5x the useful flops at that shape). The unfused chain
// stores the same tensor. The backward's h_r and dpre_r are two bf16 [T, F]
// tensors that the wrapper allocates for each backward (64 MB at 4,096
// tokens, 256 MB at 16,384), plus the fp32 partials ([ceil(T / 128), F] and
// [ceil(T / 64), D2]): what the unfused chain's autograd keeps for the same
// backward (GELU's input and fc2's input, both [T, F]). The forward still
// saves only x, the weights and the seeds.
//
// What bounds them on the H100: the tensor cores. The forward does two
// products of 2 T D F flops (at T = 4096, D = D2 = 1024, F = 4096: 68.7
// GFLOP, 0.069 ms at 989 TFLOP/s) against 2 T F bytes of workspace written
// and read back (32 MB, 0.02 ms at 3.35 TB/s, and it fits in the 50 MB L2);
// the backward five (172 GFLOP, 0.174 ms) against twice that workspace.
//
// Design. Every kernel has K1's shape (flash_fwd_hopper.cuh) and is
// persistent (one block an SM walks over tiles, so the producer fills the
// next tile's stages during a tile's epilogue): three warpgroups, a producer
// of which one thread issues TMA loads of 2-D maps (128-byte swizzle) into a
// ring of stages behind full/empty mbarriers, and two consumer warpgroups of
// 64 rows each on wgmma with fp32 accumulators in registers; a stage is 64
// deep.
//   * the products, mlp_gemm_tma_wgmma: tiles of 128 rows x BN columns (BN
//     256 where the output width allows, else 128), one m64nBN accumulator a
//     consumer warpgroup, and an epilogue chosen at compile time:
//       - F1 and F2: A (x, h_r) and B (W1, W2) both K-major as stored, B in
//         one box of BN rows; the epilogue adds the bias in fp32, F1 the
//         GELU, and applies the dropout multiplier (m1 or m2 drawn in the
//         accumulator layout with K4's drop_bits, one Philox call per 8
//         columns, while the tile's last products run), rounds to bf16 and
//         stores through shared memory by TMA, clipped at T;
//       - dx: A = dpre_r K-major, B = W1 N-major (the transposed-B
//         descriptor); out through shared memory by TMA;
//       - dW: one grid of both products; a tile of dW1 or dW2 loops over
//         every token tile in order: A (dpre_r or do2) is M-major and B (x or
//         h_r) N-major, the transpose bits of bf16 wgmma; fp32 results stored
//         from registers. The tiles of output column 0 also sum the bias
//         partials of their 128 rows in order. No atomics: the gradients are
//         bit-equal from run to run.
//   * stage H: a tile is 128 tokens x 128 hidden columns. The ring carries x
//     and W1 (both K-major) for h_pre, then do2 (K-major) and W2 (N-major,
//     through the transposed-B descriptor) for dh, 32 KB a stage, 4 stages;
//     the epilogue runs in registers (m1's bits drawn while h_pre's last
//     products run), writes h_r and dpre_r through two shared-memory tiles
//     by TMA stores that clip at T, and db1's partials in a fixed order
//     (two rows, an xor tree over a column quad, the 8 warps in order).
//   * db2: a warp reads 512 contiguous bytes of a row of do (a lane: one
//     Philox call's 8 columns), 8 warps sum a 64-token slice in order.
//   * Rows past T: TMA zero-fills x, h_r, do and the workspace there, so F1
//     and stage H hold gelu(b1) m1 in those rows of their tiles, but do2, dh
//     and dpre are 0; nothing of the forward sums over T, every sum over T
//     of the backward pairs h with do2 or dpre with x, so they add nothing,
//     and every store clips at T.
//
// Budgets (227 KB of shared memory and 64 K registers an SM; one block an
// SM): stage H 4 x 32 KB + 64 KB of output tiles + 4 KB of column sums; F1,
// F2 and dx 3 x 48 KB + 64 KB (128 x 256 tiles) or 4 x 32 KB + 32 KB; dW
// 4 x 48 KB; consumers 240 registers (stage H: two m64n128 accumulators; the
// products: one m64n256), the producer 24.

#pragma once

#include "hopper.cuh"

namespace orbit2 {
namespace mlp {

using namespace orbit2::hopper;

constexpr int kBlockRows = 128;  // tokens (stage H, dx) or output rows (dW) of a tile
constexpr int kHiddenCols = 128; // hidden columns of a stage-H tile
constexpr int kDepth = 64;       // depth of a stage: one 128-byte slab
constexpr int kThreads = 384;    // two consumer warpgroups and the producer's
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kSlabBytes = 64 * 128;          // 64 rows of a 128-byte slab
constexpr uint32_t kHalf = 2 * kSlabBytes;         // 16 KB: a stage's A (128 x 64 bf16)

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * kInvSqrt2)); }

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.f + erff(v * kInvSqrt2)) + v * expf(-0.5f * v * v) * kInvSqrt2Pi;
}

// Phi(v), the normal cdf, and e = exp(-v^2 / 2) from one exponential: erf
// by Abramowitz-Stegun 7.1.26 (|error| <= 1.5e-7), the TPU kernel's _erf
// (orbit2_tpu/ops/fused_mlp.py:57-65), whose exp(-a^2) at a = |v| / sqrt 2
// is the density's exponential. One reciprocal and one exp2 on the
// special-function unit, ~16 FMA-pipe instructions with gelu'; gelu() and
// dgelu() above (erff, expf) stay the fp32 kernels'.
__device__ __forceinline__ float normal_cdf(float v, float& e) {
  const float a = fabsf(v) * kInvSqrt2;
  const float t = __fdividef(1.f, 1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  e = __expf(-a * a);
  return 0.5f + copysignf(0.5f - 0.5f * poly * e, v);  // 0.5 (1 + erf(v / sqrt 2))
}

// gelu(v) = v Phi(v) (F1) and, for stage H, gelu'(v) = Phi(v) + v phi(v).
__device__ __forceinline__ float gelu_as(float v) {
  float e;
  return v * normal_cdf(v, e);
}

__device__ __forceinline__ void gelu_and_grad(float v, float& g, float& dg) {
  float e;
  const float phi = normal_cdf(v, e);
  g = v * phi;
  dg = phi + v * e * kInvSqrt2Pi;
}

// Shared memory of a kernel: kS stages of kStage bytes (1024-aligned, the
// swizzle's period), kStaging bytes of output tiles, kRed fp32 values for
// column sums, then the ring's barriers.
template <int kS, uint32_t kStage, uint32_t kStaging, uint32_t kRed>
struct Layout {
  static constexpr int kStages = kS;
  static constexpr uint32_t kStageBytes = kStage;
  static constexpr uint32_t kStagingAt = kS * kStage;
  static constexpr uint32_t kRedAt = kStagingAt + kStaging;
  static constexpr uint32_t kBarriers = kRedAt + 4 * kRed;
  static constexpr size_t kBytes = 1024 + kBarriers + 16 * kS;
};

// The ring of a Layout: stage i lives at base + (i % kS) kStage behind a full
// barrier (the producer's expect_tx and TMA bytes) and an empty barrier
// (every consumer thread's arrival). i counts the steps of every tile the
// block takes, so the ring runs on across tiles.
template <class L>
struct Ring {
  uint32_t base;
  __device__ uint32_t stage(int i) const { return base + (uint32_t)(i % L::kStages) * L::kStageBytes; }
  __device__ uint32_t full(int i) const { return base + L::kBarriers + 8 * (i % L::kStages); }
  __device__ uint32_t empty(int i) const {
    return base + L::kBarriers + 8 * (L::kStages + i % L::kStages);
  }
  // made by thread 0 before the block splits
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < L::kStages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 256);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // the producer: waits for stage i to be free and expects its bytes
  __device__ uint32_t claim(int i) const {
    mbar_wait(empty(i), ((i / L::kStages) & 1) ^ 1);  // the first kStages pass at once
    mbar_expect_tx(full(i), L::kStageBytes);
    return stage(i);
  }
  __device__ void wait(int i) const { mbar_wait(full(i), (i / L::kStages) & 1); }
  __device__ void release(int i) const { mbar_arrive(empty(i)); }
};

// One 64-deep step of acc (+)= A B on stage i for a consumer warpgroup:
// waits for the stage, issues its four wgmma (A at a_off, B at b_off within
// the stage; acc overwritten at step zero_at) as one group, then waits for
// the previous group and releases its stage, unless i is the tile's first
// step (one group stays in flight). kTransA: A is M-major (64 columns of M,
// 64 k rows); else K-major rows of 64 k. kTransB: B is N-major (N / 64
// slabs of 64 k rows); else K-major, N rows of 64 k. acc is not fenced here:
// its own group is still in flight on return, and an instruction touching
// it then makes ptxas serialise every wgmma of the kernel. The caller fences
// it (fence_regs) where no group of it is pending: before a tile's first
// step and after the wait that retires its last.
template <int N, bool kTransA, bool kTransB, class R>
__device__ __forceinline__ void consume_step(float (&acc)[N / 2], const R& ring, int i, int zero_at,
                                             int tile_start, uint32_t a_off, uint32_t b_off) {
  const uint32_t st = ring.stage(i);
  ring.wait(i);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    const uint64_t da = kTransA ? smem_desc(st + a_off + kk * 2048, kSlabBytes, 1024)
                                : smem_desc(st + a_off + kk * 32, 16, 1024);
    const uint64_t db = kTransB ? smem_desc(st + b_off + kk * 2048, kSlabBytes, 1024)
                                : smem_desc(st + b_off + kk * 32, 16, 1024);
    wgmma_ss<N, kTransA, kTransB>(acc, da, db, i > zero_at || kk > 0);
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (i > tile_start) ring.release(i - 1);
}

// Byte offset of element (row r, column c) of a warpgroup's 64-row bf16
// tile in shared memory: 64-column slabs in the 128-byte swizzle, the
// layout of TMA boxes of 64 rows x 64 columns.
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c / 64) * kSlabBytes + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// Waits until the previous tile's stores from a warpgroup's staging tile
// have read it (the issuing thread's bulk group), so its threads may write it.
__device__ __forceinline__ void reclaim_staging(int wg) {
  if (threadIdx.x % 128 == 0) tma_store_wait_read();
  named_barrier(1 + wg, 128);
}

// Writes a warpgroup's m64nN values, packed in bf16 pairs (element e in half
// e & 1 of pairs[e / 2]), into its staging tile at `tile`.
template <int N>
__device__ __forceinline__ void stage_tile(uint32_t tile, const uint32_t (&pairs)[N / 4], int row,
                                           int t) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int r = row + 8 * ((e >> 1) & 1);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(tile + tile_offset(r, 8 * (e / 4) + 2 * t)),
                 "r"(pairs[e / 2])
                 : "memory");
  }
}

template <int N>
__device__ __forceinline__ void pack_pairs(uint32_t (&pairs)[N / 4], const float (&v)[N / 2]) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) pairs[e / 2] = pack_bf16x2(v[e], v[e + 1]);
}

// Stores a warpgroup's staged 64 x N tile at (column c0, row r0) of `map`
// (rows past the map's end are not written) once all its 128 threads have
// written it: one thread issues the slab stores as a bulk group and goes on
// (reclaim_staging waits for it).
template <int N>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t tile, int c0, int r0,
                                           int wg, bool live) {
  fence_async_smem();
  named_barrier(1 + wg, 128);
  if (live && threadIdx.x % 128 == 0) {
#pragma unroll
    for (int j = 0; j < N / 64; ++j) tma_store_2d(map, tile + j * kSlabBytes, c0 + 64 * j, r0);
    tma_store_commit();
  }
}

// ---- stage H -------------------------------------------------------------------

struct HiddenParams {
  const bf16* b1;   // [F]
  float* db1_part;  // [ceil(T / 128), F], or null: dpre_r alone (dx)
  int tokens, d, f, d2;
  Dropout drop1;
};

// 4 stages of A 16 KB + B 16 KB; the dpre_r and h_r tiles (64 x 128, 16 KB)
// of both warpgroups; the column sums of 8 warps.
using HiddenLayout = Layout<4, 2 * kHalf, 4 * kHalf, 8 * kHiddenCols>;

// Persistent: block b takes the tiles b, b + gridDim.x, ... of (F / 128) x
// ceil(T / 128), hidden-column tile fastest. Maps: x [T, D], W1 [F, D] and
// do2 [T, D2] in boxes of 128 rows; W2 [D2, F] and the workspace dpre_r, h_r
// [T, F] in boxes of 64 rows.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
mlp_hidden_bwd_tma_wgmma(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w1_map,
                         const __grid_constant__ CUtensorMap do2_map,
                         const __grid_constant__ CUtensorMap w2_map,
                         const __grid_constant__ CUtensorMap dpre_map,
                         const __grid_constant__ CUtensorMap h_map, const HiddenParams p) {
  using L = HiddenLayout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const Ring<L> ring{(base + 1023u) & ~1023u};
  const uint32_t staging = ring.base + L::kStagingAt;
  float* const red = reinterpret_cast<float*>(smem_raw + (ring.base - base) + L::kRedAt);
  const int nf = p.f / kHiddenCols;
  const int tiles = nf * ((p.tokens + kBlockRows - 1) / kBlockRows);
  const int n1 = p.d / kDepth;   // steps of h_pre
  const int n2 = p.d2 / kDepth;  // steps of dh
  ring.init();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, across tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int f0 = (tile % nf) * kHiddenCols;
        const int t0 = (tile / nf) * kBlockRows;
        for (int k = 0; k < n1; ++k, ++i) {
          const uint32_t st = ring.claim(i);
          tma_load_2d(st, &x_map, ring.full(i), k * kDepth, t0);
          tma_load_2d(st + kHalf, &w1_map, ring.full(i), k * kDepth, f0);
        }
        for (int k = 0; k < n2; ++k, ++i) {
          const uint32_t st = ring.claim(i);
          tma_load_2d(st, &do2_map, ring.full(i), k * kDepth, t0);
          tma_load_2d(st + kHalf, &w2_map, ring.full(i), f0, k * kDepth);
          tma_load_2d(st + kHalf + kSlabBytes, &w2_map, ring.full(i), f0 + 64, k * kDepth);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 tokens each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = 16 * ((threadIdx.x / 32) % 4) + g;  // within the warpgroup's 64 rows
  const uint32_t tile_d = staging + wg * 2 * kHalf;  // this warpgroup's dpre_r tile
  const uint32_t tile_h = tile_d + kHalf;            // and its h_r tile
  float hp[kHiddenCols / 2];
  float dh[kHiddenCols / 2];
#pragma unroll
  for (int e = 0; e < kHiddenCols / 2; ++e) hp[e] = dh[e] = 0.f;

  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int f0 = (tile % nf) * kHiddenCols;
    const int tt = tile / nf;
    const int t0 = tt * kBlockRows;
    const int token = t0 + 64 * wg + row;  // and token + 8
    uint32_t bias[kHiddenCols / 8];        // b1 of this thread's 16 column pairs
#pragma unroll
    for (int j = 0; j < kHiddenCols / 8; ++j)
      bias[j] = *reinterpret_cast<const uint32_t*>(p.b1 + f0 + 8 * j + 2 * t);
    fence_regs(hp);  // no group is pending: the last tile ended on wait<0>
    fence_regs(dh);
    for (int k = 0; k < n1; ++k)
      consume_step<kHiddenCols, false, false>(hp, ring, i + k, i, i, wg * kSlabBytes, kHalf);
    uint32_t dropped[kHiddenCols / 64];  // kDrop: m1's drop flags, drawn while h_pre finishes
    if constexpr (kDrop) drop_bits<kHiddenCols>(dropped, token, f0, t, 0, p.drop1);
    for (int k = 0; k < n2; ++k)
      consume_step<kHiddenCols, false, true>(dh, ring, i + n1 + k, i + n1, i, wg * kSlabBytes,
                                             kHalf);
    wgmma_wait<0>();
    fence_regs(hp);
    fence_regs(dh);
    i += n1 + n2;
    ring.release(i - 1);

    // the GELU after the products: h_r = bf16(gelu(h_pre) m1) into hr, and
    // dpre = dh m1 gelu'(h_pre) into dh. Beside dh's products it did not pay
    // (PERF.md): read in the accumulators' registers there, h_pre made ptxas
    // serialise every wgmma of the kernel, whatever wait preceded it, and a
    // copy through shared memory gained little or lost.
    uint32_t hr[kHiddenCols / 4];
#pragma unroll
    for (int e = 0; e < kHiddenCols / 2; e += 2) {
      float h[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t pair = bias[(e + c) / 4];
        const float b = __uint_as_float(c ? (pair & 0xFFFF0000u) : (pair << 16));
        float grad;
        gelu_and_grad(hp[e + c] + b, h[c], grad);
        float d = dh[e + c];
        if constexpr (kDrop) {
          const float m = ((dropped[(e + c) / 32] >> ((e + c) % 32)) & 1u) ? 0.f : p.drop1.scale;
          h[c] *= m;
          d *= m;
        }
        dh[e + c] = d * grad;
      }
      hr[e / 2] = pack_bf16x2(h[0], h[1]);
    }
    // the workspace: dpre_r (and h_r) through the warpgroup's staging tiles
    reclaim_staging(wg);
    {
      uint32_t pairs[kHiddenCols / 4];
      pack_pairs<kHiddenCols>(pairs, dh);
      stage_tile<kHiddenCols>(tile_d, pairs, row, t);
    }
    if (p.db1_part != nullptr) stage_tile<kHiddenCols>(tile_h, hr, row, t);
    fence_async_smem();
    named_barrier(1 + wg, 128);
    if (t0 + 64 * wg < p.tokens && threadIdx.x % 128 == 0) {  // rows past T: nothing
      tma_store_2d(&dpre_map, tile_d, f0, t0 + 64 * wg);
      tma_store_2d(&dpre_map, tile_d + kSlabBytes, f0 + 64, t0 + 64 * wg);
      if (p.db1_part != nullptr) {
        tma_store_2d(&h_map, tile_h, f0, t0 + 64 * wg);
        tma_store_2d(&h_map, tile_h + kSlabBytes, f0 + 64, t0 + 64 * wg);
      }
      tma_store_commit();
    }
    if (p.db1_part == nullptr) continue;

    // db1: column sums of dpre (unrounded) over the tile's 128 tokens; rows
    // past T hold dpre = 0. A thread's two rows, then the 8 rows of its
    // column quad (xor tree), then the 8 warps in order.
    named_barrier(3, 256);  // the previous tile's reads of red are done
#pragma unroll
    for (int e = 0; e < kHiddenCols / 2; e += 4) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = dh[e + c] + dh[e + 2 + c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[(threadIdx.x / 32) * kHiddenCols + 8 * (e / 4) + 2 * t + c] = v;
      }
    }
    named_barrier(3, 256);
    if (threadIdx.x < kHiddenCols) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w * kHiddenCols + threadIdx.x];
      p.db1_part[(int64_t)tt * p.f + f0 + threadIdx.x] = sum;
    }
  }
  if (threadIdx.x % 128 == 0) tma_store_wait_read();
}

// ---- db2 ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;  // 8 warps
constexpr int kSumRows = 64;      // tokens of a db2 partial: 8 rows a warp

// The partial sums of db2 = sum_t do m2 (fp32, unrounded): block (b, s)
// takes columns 256 b .. 256 b + 255 over the tokens of slice s (kSumRows
// of them). Lane l of a warp owns columns 256 b + 8 l .. + 7 (one Philox
// call of m2 a row, a 16-byte load: a warp reads 512 contiguous bytes of a
// row), warp w rows w, w + 8, ...; the 8 warps are summed in order into
// part[s] (the dW kernel sums the slices in order).
template <bool kDrop>
__global__ void __launch_bounds__(kSumThreads)
mlp_bias2_partials(const bf16* __restrict__ dout, float* __restrict__ part, int tokens, int d2,
                   Dropout drop2) {
  __shared__ float red[kSumThreads / 32][256];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = 256 * blockIdx.x + 8 * lane;
  constexpr int kPer = kSumRows / (kSumThreads / 32);
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  uint4 v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int r = blockIdx.y * kSumRows + warp + 8 * u;
    v[u] = r < tokens && col < d2 ? *reinterpret_cast<const uint4*>(dout + (int64_t)r * d2 + col)
                                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    uint32_t flags = 0u;
    if constexpr (kDrop) {
      const int r = blockIdx.y * kSumRows + warp + 8 * u;
      flags = drop_flags8(drop2.seed, 0u, (uint32_t)r, (uint32_t)(col / 8), drop2.threshold);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = __uint_as_float((j & 1) ? (w[j / 2] & 0xFFFF0000u) : (w[j / 2] << 16));
      if constexpr (kDrop) x *= ((flags >> j) & 1u) ? 0.f : drop2.scale;
      sum[j] += x;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[warp][8 * lane + j] = sum[j];
  __syncthreads();
  const int c = 256 * blockIdx.x + threadIdx.x;
  if (c < d2) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kSumThreads / 32; ++w) total += red[w][threadIdx.x];
    part[(int64_t)blockIdx.y * d2 + c] = total;
  }
}

// ---- the products: F1 and F2, dx, and dW1 with dW2 ------------------------------

// What a product does with its fp32 tile before it stores it.
enum Epilogue : int {
  kPlain = 0,   // dx (bf16 through shared memory) or dW (fp32 from registers)
  kHidden = 1,  // F1: bf16(gelu(acc + b1) m1)
  kOutput = 2,  // F2: bf16((acc + b2) m2)
};

// out (+)= A B over depth k for an m x n output: A [m, k] K-major (F1, F2,
// dx) or read as the M-major [k, m] (dW: A^T of a [T, m] tensor); B the
// K-major [n, k] (F1, F2: a weight as stored) or the N-major [k, n] (dx,
// dW). A dW problem also sums its bias gradient's partials (part [n_part,
// m], over the token tiles in order) into bias_grad [m], in the tiles of
// output column 0.
struct GemmProblem {
  int m, n, k;
  void* out;  // [m, n]: dW fp32, the others bf16
  const float* part;
  float* bias_grad;
  int n_part;
};

struct GemmParams {
  GemmProblem prob[2];
  int tiles0;  // tiles of prob[0]; prob[1]'s follow
  int tiles;
  const bf16* bias;  // F1, F2: [n], added in fp32
  Dropout drop;      // F1, F2 with kDrop: the output's mask
};

// A stage: A 16 KB and B 64 k x BN; F1, F2 and dx stage their two 64 x BN
// output tiles.
template <bool kTransA, int BN>
using GemmLayout = Layout<BN == 256 && !kTransA ? 3 : 4, kHalf + BN * 128,
                          kTransA ? 0 : 2 * BN * 128, 0>;

// F1's and F2's epilogue on a warpgroup's m64nBN tile, packed into bf16
// pairs as pack_pairs packs them: + the bias of the tile's columns in fp32,
// the GELU (F1), the dropout multiplier (kDrop: bit e % 32 of dropped[e /
// 32], drop_bits's layout), one rounding. The bias is read a column pair at
// a time beside the arithmetic that uses it. acc is only read: no group of
// it is pending, and ptxas sees no write to it.
template <int kEpi, bool kDrop, int BN>
__device__ __forceinline__ void bias_act_mask(uint32_t (&pairs)[BN / 4], const float (&acc)[BN / 2],
                                              const bf16* bias, int t,
                                              const uint32_t (&dropped)[BN / 64], float scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {  // columns 8 j + 2 t and + 1 of rows row and row + 8
    const uint32_t pair = *reinterpret_cast<const uint32_t*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * h + c;
        v[c] = acc[e] + __uint_as_float(c ? (pair & 0xFFFF0000u) : (pair << 16));
        if constexpr (kEpi == kHidden) v[c] = gelu_as(v[c]);
        if constexpr (kDrop) v[c] *= ((dropped[e / 32] >> (e % 32)) & 1u) ? 0.f : scale;
      }
      pairs[2 * j + h] = pack_bf16x2(v[0], v[1]);
    }
  }
}

// Persistent over the tiles of 128 x BN of both problems (output column tile
// fastest). kTransA false: F1, F2 or dx, one problem, A's map in boxes of 128
// rows, B's in BN rows (K-major, F1 and F2) or 64 (N-major, dx), the bf16
// result through out_map (boxes of 64 rows). kTransA true: dW, two
// problems, every map in boxes of 64 rows, fp32 results stored directly.
template <bool kTransA, int BN, int kEpi = kPlain, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, 1)
mlp_gemm_tma_wgmma(const __grid_constant__ CUtensorMap a0_map,
                   const __grid_constant__ CUtensorMap b0_map,
                   const __grid_constant__ CUtensorMap a1_map,
                   const __grid_constant__ CUtensorMap b1_map,
                   const __grid_constant__ CUtensorMap out_map, const GemmParams p) {
  static_assert(kEpi == kPlain || !kTransA, "F1 and F2 take A K-major");
  static_assert(kEpi != kPlain || !kDrop, "dx and dW have no dropout epilogue");
  constexpr bool kTransB = kEpi == kPlain;  // dx, dW: B N-major; F1, F2: the weights as stored
  using L = GemmLayout<kTransA, BN>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<L> ring{(smem_u32(smem_raw) + 1023u) & ~1023u};
  ring.init();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int i = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int which = tile >= p.tiles0;
        const GemmProblem pr = which ? p.prob[1] : p.prob[0];
        const int local = tile - (which ? p.tiles0 : 0);
        const int m0 = (local / (pr.n / BN)) * kBlockRows;
        const int n0 = (local % (pr.n / BN)) * BN;
        const CUtensorMap* a_map = which ? &a1_map : &a0_map;
        const CUtensorMap* b_map = which ? &b1_map : &b0_map;
        for (int k0 = 0; k0 < pr.k; k0 += kDepth, ++i) {
          const uint32_t st = ring.claim(i);
          if constexpr (kTransA) {
            tma_load_2d(st, a_map, ring.full(i), m0, k0);
            tma_load_2d(st + kSlabBytes, a_map, ring.full(i), m0 + 64, k0);
          } else {
            tma_load_2d(st, a_map, ring.full(i), k0, m0);
          }
          if constexpr (kTransB) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(st + kHalf + j * kSlabBytes, b_map, ring.full(i), n0 + 64 * j, k0);
          } else {
            tma_load_2d(st + kHalf, b_map, ring.full(i), k0, n0);  // BN rows of 64 k
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = 16 * ((threadIdx.x / 32) % 4) + g;
  const uint32_t staging = ring.base + L::kStagingAt + wg * BN * 128;
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

  int i = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int which = tile >= p.tiles0;
    const GemmProblem pr = which ? p.prob[1] : p.prob[0];  // selects, no indexed parameter
    const int local = tile - (which ? p.tiles0 : 0);
    const int m0 = (local / (pr.n / BN)) * kBlockRows;
    const int n0 = (local % (pr.n / BN)) * BN;
    const int steps = (pr.k + kDepth - 1) / kDepth;
    // A's rows of this warpgroup: its M-major slab, or rows 64 wg.. of the K-major tile
    for (int k = 0; k < steps; ++k)
      consume_step<BN, kTransA, kTransB>(acc, ring, i + k, i, i, wg * kSlabBytes, kHalf);
    uint32_t dropped[BN / 64];  // kDrop: the tile's drop flags, drawn while its last group runs
    if constexpr (kDrop) drop_bits<BN>(dropped, m0 + 64 * wg + row, n0, t, 0, p.drop);
    wgmma_wait<0>();
    fence_regs(acc);
    i += steps;
    ring.release(i - 1);

    if constexpr (!kTransA) {
      uint32_t pairs[BN / 4];
      if constexpr (kEpi == kPlain) {
        pack_pairs<BN>(pairs, acc);
      } else {
        bias_act_mask<kEpi, kDrop, BN>(pairs, acc, p.bias + n0, t, dropped, p.drop.scale);
      }
      reclaim_staging(wg);
      stage_tile<BN>(staging, pairs, row, t);
      store_tile<BN>(&out_map, staging, n0, m0 + 64 * wg, wg, m0 + 64 * wg < pr.m);
    } else {
      float* out = static_cast<float*>(pr.out);
#pragma unroll
      for (int e = 0; e < BN / 2; e += 2) {
        const int r = m0 + 64 * wg + row + 8 * ((e >> 1) & 1);
        *reinterpret_cast<float2*>(out + (int64_t)r * pr.n + n0 + 8 * (e / 4) + 2 * t) =
            make_float2(acc[e], acc[e + 1]);
      }
      if (n0 == 0 && threadIdx.x < kBlockRows) {
        float sum = 0.f;
#pragma unroll 8
        for (int j = 0; j < pr.n_part; ++j) sum += pr.part[(int64_t)j * pr.m + m0 + threadIdx.x];
        pr.bias_grad[m0 + threadIdx.x] = sum;
      }
    }
  }
  if (!kTransA && threadIdx.x % 128 == 0) tma_store_wait_read();
}

// ---- host side --------------------------------------------------------------------

inline int token_tiles(int tokens) { return (tokens + kBlockRows - 1) / kBlockRows; }

// The persistent grids' size: one block an SM of the current device.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 1;
  return n;
}

// Launches a product kernel. Returns 0 or a cudaError_t code.
template <bool kTransA, int BN, int kEpi = kPlain, bool kDrop = false>
int launch_gemm(const CUtensorMap* maps, const GemmParams& prm, cudaStream_t stream) {
  const auto kernel = mlp_gemm_tma_wgmma<kTransA, BN, kEpi, kDrop>;
  const size_t smem = GemmLayout<kTransA, BN>::kBytes;
  const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  const int grid = prm.tiles < sm_count() ? prm.tiles : sm_count();
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], prm);
  return (int)cudaGetLastError();
}

// ---- the forward ---------------------------------------------------------------

struct FwdOperands {
  const bf16* x;   // [T, D]
  const bf16* w1;  // [F, D]
  const bf16* b1;  // [F]
  const bf16* w2;  // [D2, F]
  const bf16* b2;  // [D2]
  bf16* h;         // workspace [T, F]: h_r
  bf16* out;       // [T, D2]
  int tokens, d, f, d2;
  Dropout drop1, drop2;
};

// One of the forward's products, out = epi(A B^T) with A [T, k] and B [n, k]
// both K-major, into out [T, n]: tiles of 128 x 256 where n allows.
template <int kEpi>
int launch_fwd_product(const bf16* a, const bf16* b, const bf16* bias, bf16* out, int tokens,
                       int n, int k, const Dropout& drop, bool dropout, cudaStream_t stream) {
  const int bn = n % 256 == 0 ? 256 : 128;
  CUtensorMap maps[5];
  const bool ok = encode_map_2d(&maps[0], a, tokens, k, k, kBlockRows) &&
                  encode_map_2d(&maps[1], b, n, k, k, bn) &&
                  encode_map_2d(&maps[4], out, tokens, n, n, 64);
  if (!ok) return kEncodeFailed;
  maps[2] = maps[0];
  maps[3] = maps[1];
  GemmParams prm{};
  prm.prob[0] = GemmProblem{tokens, n, k, out, nullptr, nullptr, 0};
  prm.tiles0 = prm.tiles = token_tiles(tokens) * (n / bn);
  prm.bias = bias;
  prm.drop = drop;
  if (bn == 256) {
    return dropout ? launch_gemm<false, 256, kEpi, true>(maps, prm, stream)
                   : launch_gemm<false, 256, kEpi, false>(maps, prm, stream);
  }
  return dropout ? launch_gemm<false, 128, kEpi, true>(maps, prm, stream)
                 : launch_gemm<false, 128, kEpi, false>(maps, prm, stream);
}

// F1, h_r = bf16(gelu(x W1^T + b1) m1) into the workspace, then F2, out =
// bf16((h_r W2^T + b2) m2), on the same stream.
inline int launch_fwd(const FwdOperands& o, bool dropout, cudaStream_t stream) {
  const int err = launch_fwd_product<kHidden>(o.x, o.w1, o.b1, o.h, o.tokens, o.f, o.d, o.drop1,
                                              dropout, stream);
  if (err) return err;
  return launch_fwd_product<kOutput>(o.h, o.w2, o.b2, o.out, o.tokens, o.d2, o.f, o.drop2,
                                     dropout, stream);
}

// ---- the backward --------------------------------------------------------------

struct BwdOperands {
  const bf16* x;      // [T, D]
  const bf16* w1;     // [F, D]
  const bf16* b1;     // [F]
  const bf16* w2;     // [D2, F]
  const bf16* dout;   // [T, D2], unmasked
  const bf16* dout2;  // [T, D2], do2 (dout at rate 0)
  bf16* dpre;         // workspace [T, F]
  bf16* h;            // workspace [T, F], or null with the partials: dx alone
  float* db1_part;    // [ceil(T / 128), F]
  float* db2_part;    // [ceil(T / 64), D2]
  int tokens, d, f, d2;
  Dropout drop1, drop2;
};

// Launches stage H. Returns 0, a cudaError_t code, or kEncodeFailed.
template <bool kDrop>
int launch_hidden(const BwdOperands& o, cudaStream_t stream) {
  CUtensorMap maps[6];
  const bool ok =
      encode_map_2d(&maps[0], o.x, o.tokens, o.d, o.d, kBlockRows) &&
      encode_map_2d(&maps[1], o.w1, o.f, o.d, o.d, kHiddenCols) &&
      encode_map_2d(&maps[2], o.dout2, o.tokens, o.d2, o.d2, kBlockRows) &&
      encode_map_2d(&maps[3], o.w2, o.d2, o.f, o.f, kDepth) &&
      encode_map_2d(&maps[4], o.dpre, o.tokens, o.f, o.f, 64) &&
      encode_map_2d(&maps[5], o.h != nullptr ? o.h : o.dpre, o.tokens, o.f, o.f, 64);
  if (!ok) return kEncodeFailed;
  const HiddenParams prm{o.b1, o.h != nullptr ? o.db1_part : nullptr, o.tokens, o.d, o.f, o.d2,
                         o.drop1};
  const auto kernel = mlp_hidden_bwd_tma_wgmma<kDrop>;
  // at every launch: the limit belongs to the function in the current device's context
  const cudaError_t allowed = allow_smem(kernel, HiddenLayout::kBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const int tiles = (o.f / kHiddenCols) * token_tiles(o.tokens);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, kThreads, HiddenLayout::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                           maps[4], maps[5], prm);
  return (int)cudaGetLastError();
}

// dx = dpre_r W1 into dx [T, D] (bf16): tiles of 128 x 256 where D allows.
inline int launch_dx(const BwdOperands& o, bf16* dx, cudaStream_t stream) {
  const int bn = o.d % 256 == 0 ? 256 : 128;
  CUtensorMap maps[5];
  const bool ok = encode_map_2d(&maps[0], o.dpre, o.tokens, o.f, o.f, kBlockRows) &&
                  encode_map_2d(&maps[1], o.w1, o.f, o.d, o.d, kDepth) &&
                  encode_map_2d(&maps[4], dx, o.tokens, o.d, o.d, 64);
  if (!ok) return kEncodeFailed;
  maps[2] = maps[0];
  maps[3] = maps[1];
  GemmParams prm{};
  prm.prob[0] = GemmProblem{o.tokens, o.d, o.f, dx, nullptr, nullptr, 0};
  prm.tiles0 = prm.tiles = token_tiles(o.tokens) * (o.d / bn);
  return bn == 256 ? launch_gemm<false, 256>(maps, prm, stream)
                   : launch_gemm<false, 128>(maps, prm, stream);
}

// db2's partial sums from the unmasked output gradient (mlp_bias2_partials).
template <bool kDrop>
int launch_bias2(const BwdOperands& o, cudaStream_t stream) {
  const dim3 grid((unsigned)((o.d2 + 255) / 256), (unsigned)((o.tokens + kSumRows - 1) / kSumRows));
  mlp_bias2_partials<kDrop><<<grid, kSumThreads, 0, stream>>>(o.dout, o.db2_part, o.tokens, o.d2,
                                                              o.drop2);
  return (int)cudaGetLastError();
}

// dW1 = dpre_r^T x [F, D] and dW2 = do2^T h_r [D2, F], fp32, with db1 and db2
// from their partials: tiles of 128 x 256 where D and F allow.
inline int launch_dw(const BwdOperands& o, float* dw1, float* db1, float* dw2, float* db2,
                     cudaStream_t stream) {
  const int bn = o.d % 256 == 0 && o.f % 256 == 0 ? 256 : 128;
  CUtensorMap maps[5];
  const bool ok = encode_map_2d(&maps[0], o.dpre, o.tokens, o.f, o.f, kDepth) &&
                  encode_map_2d(&maps[1], o.x, o.tokens, o.d, o.d, kDepth) &&
                  encode_map_2d(&maps[2], o.dout2, o.tokens, o.d2, o.d2, kDepth) &&
                  encode_map_2d(&maps[3], o.h, o.tokens, o.f, o.f, kDepth);
  if (!ok) return kEncodeFailed;
  maps[4] = maps[0];
  const int parts = token_tiles(o.tokens);
  GemmParams prm{};
  prm.prob[0] = GemmProblem{o.f, o.d, o.tokens, dw1, o.db1_part, db1, parts};
  prm.prob[1] = GemmProblem{o.d2, o.f, o.tokens, dw2, o.db2_part, db2,
                            (o.tokens + kSumRows - 1) / kSumRows};
  prm.tiles0 = (o.f / kBlockRows) * (o.d / bn);
  prm.tiles = prm.tiles0 + (o.d2 / kBlockRows) * (o.f / bn);
  return bn == 256 ? launch_gemm<true, 256>(maps, prm, stream)
                   : launch_gemm<true, 128>(maps, prm, stream);
}

}  // namespace mlp
}  // namespace orbit2

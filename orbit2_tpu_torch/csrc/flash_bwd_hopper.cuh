// The bf16 flash-attention backward for Hopper (sm_90a): K2
// (flash_bwd_dq_tma_wgmma, dq) and K3 (flash_bwd_dkv_tma_wgmma, dk and dv),
// built from the forward's pieces (flash_fwd_hopper.cuh): its TMA maps and
// ring, its producer warp, its two wgmma forms and its in-register dropout
// bits.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (orbit2_tpu/ops/flash_attention.py:287, :328; launched at :386, :410).
// With s = q k^T * scale * log2(e), p = exp2(s - lse) (the forward's base-2
// lse, fp32 [B*H, N_q]), dp = do v^T times the dropout multiplier m in
// {0, 1/keep}, delta = rowsum(o do) (the caller's) and
// ds = p (dp - delta) * scale:
//
//   K2: dq = sum_kv ds k          K3: dv = sum_q (p m)^T do,  dk = sum_q ds^T q
//
// What bounds them on the H100: K2 does three products of N_q x N_k x D per
// head (s, dp, dq), K3 four (s^T, dp^T, dv, dk), against reading q, k, v
// and do once (at (B8, N2048, H16, d64) 0.208 and 0.278 ms at 989 TFLOP/s);
// with dropout each also regenerates the forward's mask, one 10-round
// Philox call per 8 scores on the integer pipes, as K1 does.
//
// Design. Both kernels have K1's shape: a block of three warpgroups, a
// producer (24 registers a thread after setmaxnreg) of which one warp works,
// and two consumer warpgroups (240 registers) of 64 rows each. No block
// writes another's rows and there are no atomics, so dq, dk and dv are
// bit-equal from run to run.
//   * K2 is query-major: a block owns one (batch*head, 128-query tile). The
//     producer loads q and do once and streams the k and v tiles into a
//     ring of stages behind full/empty mbarriers. A consumer warpgroup
//     issues s = q k^T and dp = do v^T (wgmma, both operands K-major from
//     shared memory), draws the dropout bits while they run (K1's drop_bits:
//     the accumulator layout is the forward's), forms ds in registers,
//     packs it to bf16 as the A operand of dq += ds k (wgmma RS form), with
//     k read row-major through the transposed-B descriptor, as K1 reads v.
//   * K3 is key-major: a block owns one (batch*head, 128-key tile). The
//     producer loads k and v once and streams the q and do tiles, and their
//     lse and delta rows (plain loads of the producer warp, +inf and 0 past
//     N_q, so p = 0 there), into the ring. A consumer warpgroup holds its 64
//     keys' dk and dv in registers and issues s^T = k q^T and
//     dp^T = v do^T (both K-major), then dv += (p m)^T do and dk += ds^T q
//     (RS form; do and q read row-major through the transposed-B
//     descriptor, from the same 128-byte-swizzled stage the score products
//     read K-major). lse and delta are indexed by the column of s^T, so they
//     come from shared memory.
//   * The dropout bits are drawn while a warpgroup's products run, the
//     next tile's beside the gradient products where the score
//     accumulators leave too few registers for the Philox calls beside
//     them (K3 at d 64), else the tile's own beside the score products.
//   * K3's dropout bits (drop_bits_t): a Philox call covers 8 consecutive
//     keys of one query, and consecutive keys are rows of s^T, held by the 8
//     lanes g = 0..7 of one t. Those lanes share the 4 calls (2 query
//     columns x 2 row halves) of each column group; each lane draws one
//     call for half of the groups, and three exchanges of packed drop flags
//     (lanes 4, 8 and 16 apart) hand every lane its own: one call per 8
//     scores, as in K1, and no keep tile.
//   * Rows past N (TMA's zero rows): K2 masks keys past N_k to p = 0; query
//     rows past N_q and key rows past N_k are computed and not stored.
//
// Measured (PERF.md, chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): at
// (B8, N2048, H16, d64) 0.39 ms (K2) and 0.53 ms (K3) of kernel time
// without dropout, about half of their tensor-core bounds, and 0.69 and
// 0.79 ms with dropout 0.1, where the Philox calls take ~0.3 ms of each.
//
// Tiles and budgets (227 KB of shared memory and 64 K registers an SM; one
// block an SM):
//   K2  D  BK  stages  shared memory (q + do + stages x (k + v))  consumer registers
//       64 128  4      16 + 16 + 4 x 32 = 160 KB                  s 64, dp 64, dq 32, ds 32
//      128  64  4      32 + 32 + 4 x 32 = 192 KB                  s 32, dp 32, dq 64, ds 16
//   K3  D  BQ  stages  shared memory (k + v + stages x (q + do + lse + delta))
//       64 128  4      16 + 16 + 4 x 33 = 164 KB                  s 64, dp 64, dk 32, dv 32, p 32, ds 32
//      128  64  4      32 + 32 + 4 x 32.5 = 194 KB                s 32, dp 32, dk 64, dv 64, p 16, ds 16
// (ds and p, the bf16 A operands, replace s and dp as those die) with
// 24 x 128 + 240 x 256 = 64,512 registers a block. At D = 256, dk and dv
// alone would take 256 registers a thread; that head dim keeps the
// mma.sync kernels of flash_attn_bwd.cu.

#pragma once

#include "flash_fwd_hopper.cuh"

namespace orbit2 {
namespace hopper {

constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;
constexpr int kBlockKey = 64 * kConsumers;  // K3: keys of a block

struct BwdParams {
  bf16* out0;          // dq (K2) or dk (K3): [B, N, H, D] contiguous
  bf16* out1;          // dv (K3)
  const float* lse;    // [B*H, N_q]
  const float* delta;  // [B*H, N_q]
  int heads, n_q, n_k;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e), as the forward rounds it
  Dropout drop;
};

template <int D>
struct DqTiles {
  static constexpr int kBlockK = D == 64 ? 128 : 64;
  static constexpr int kStages = 4;
  static constexpr int kSlabs = D / kSlab;
  static constexpr uint32_t kQBytes = kBlockQ * D * 2;  // the q tile, and the do tile
  static constexpr uint32_t kKBytes = kBlockK * D * 2;  // a k tile, and a v tile
  static constexpr uint32_t kStageBytes = 2 * kKBytes;
  static constexpr uint32_t kBarriers = 2 * kQBytes + kStages * kStageBytes;
  static constexpr size_t kSmemBytes = 1024 + kBarriers + 8 * (2 * kStages + 1);
};

template <int D>
struct DkvTiles {
  static constexpr int kBlockQ2 = D == 64 ? 128 : 64;  // query rows a stage
  // where a tile's dropout bits are drawn: beside its own score products
  // (d 128), or beside the previous tile's gradient products (d 64, where
  // the 128-query scores hold 128 registers while their products run)
  static constexpr bool kDrawLate = kBlockQ2 == 128;
  static constexpr int kStages = 4;
  static constexpr int kSlabs = D / kSlab;
  static constexpr uint32_t kKBytes = kBlockKey * D * 2;  // the k tile, and the v tile
  static constexpr uint32_t kQBytes = kBlockQ2 * D * 2;  // a q tile, and a do tile
  static constexpr uint32_t kStageBytes = 2 * kQBytes;
  static constexpr uint32_t kRowBytes = 2 * kBlockQ2 * 4;  // a stage's lse and delta
  static constexpr uint32_t kRowsAt = 2 * kKBytes + kStages * kStageBytes;
  static constexpr uint32_t kBarriers = kRowsAt + kStages * kRowBytes;
  static constexpr size_t kSmemBytes = 1024 + kBarriers + 8 * (2 * kStages + 1);
};

// Writes a warpgroup's m64nD accumulator, rows `row` and row + 8 of this
// thread, to a contiguous [B, N, H, D] bf16 tensor; rows past n are not
// stored.
template <int D>
__device__ __forceinline__ void store_tile_rows(bf16* out, const float (&acc)[D / 2], int b, int h,
                                                int heads, int n, int row, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i < n) {
      bf16* orow = out + (((int64_t)b * n + i) * heads + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// K2: s (the scores of kv columns k0 ..) becomes ds = p (dp m - delta) scale,
// with p = 0 past n_k, computed as p (dp (m scale) - delta_s): delta_s is
// delta times scale, and m is 1 or the dropout multiplier of `dropped`
// (drop_bits' layout, as drop_scores reads it).
template <int BK, bool kDropout>
__device__ __forceinline__ void dq_score_grads(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                               const float (&lse)[2], const float (&delta_s)[2],
                                               const uint32_t (&dropped)[BK / 64], int k0, int t,
                                               const BwdParams& prm) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) s[e] = s[e] * prm.scale_log2 - lse[(e >> 1) & 1];
  mask_tail<BK>(s, k0, prm.n_k, t, -INFINITY);
  const float kept = kDropout ? prm.drop.scale * prm.scale : prm.scale;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    float m = kept;
    if constexpr (kDropout) m = ((dropped[e / 32] >> (e % 32)) & 1u) ? 0.f : kept;
    s[e] = exp2_fast(s[e]) * (dp[e] * m - delta_s[(e >> 1) & 1]);
  }
}

// K3's dropout drop flags for the transposed tile: rows are the keys key_row
// (= k0 + 64 wg + 16 warp + g) and key_row + 8, columns the queries
// q0 + 8i + 2t + c. A Philox call covers keys 8j .. 8j + 7 of one query,
// which the lanes g = 0..7 of one t hold as rows (word g / 2, half g % 2).
// Lane g draws the call of query column c = g & 1, row half r = (g >> 1) & 1
// for the column groups i of parity g >> 2 (BQ / 16 calls, packed 4 calls a
// word), and three exchanges (lanes 4, 8 and 16 apart) transpose the flags:
// element e = 4i + 2r + c of the accumulator is dropped when bit e % 32 of
// dropped[e / 32] is set, a shift known at compile time.
template <int BQ>
__device__ __forceinline__ void drop_bits_t(uint32_t (&dropped)[BQ / 64], int key_row, int q0,
                                            int g, int t, int bh, const Dropout& drop) {
  const uint32_t key8 = (uint32_t)((key_row - g) / 8 + ((g >> 1) & 1));
  const uint32_t col = (uint32_t)(q0 + 8 * (g >> 2) + 2 * t + (g & 1));
  const uint32_t addend = drop_addend(drop.threshold);
#pragma unroll
  for (int w = 0; w < BQ / 64; ++w) {
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 3; k >= 0; --k) {  // call k of the word: column group 2 (4 w + k) + (g >> 2)
      const uint32_t query = col + 16 * (4 * w + k);
      acc = shift_in_drop8(acc, dropout_bits8(drop.seed, (uint32_t)bh, query, key8), addend);
    }
    acc = trade_flags<4, 1>(acc, g & 1);   // the query column, for the key's half
    acc = trade_flags<8, 2>(acc, g & 2);   // the row half, for bit 0 of its word
    dropped[w] = trade_flags<16, 4>(acc, g & 4);  // the group parity, for bit 1
  }
}

// K3: with p = exp2(s^T - lse[column]) (0 past n_q, where lse is +inf) and
// the multiplier m, dp^T becomes ds^T = p (dp^T m scale - delta scale) and
// s^T becomes (p m)^T. `rows` is the stage's lse [BQ], then delta scale [BQ].
template <int BQ, bool kDropout>
__device__ __forceinline__ void dkv_score_grads(float (&st)[BQ / 2], float (&dpt)[BQ / 2],
                                                const uint32_t (&dropped)[BQ / 64],
                                                const float* rows, int t,
                                                const BwdParams& prm) {
  const float* lse = rows;
  const float* delta_s = rows + BQ;
#pragma unroll
  for (int e = 0; e < BQ / 2; ++e) {
    const int col = 8 * (e / 4) + 2 * t + (e & 1);
    const float p = exp2_fast(st[e] * prm.scale_log2 - lse[col]);
    if constexpr (kDropout) {
      const float m = ((dropped[e / 32] >> (e % 32)) & 1u) ? 0.f : prm.drop.scale;
      dpt[e] = p * (dpt[e] * (m * prm.scale) - delta_s[col]);
      st[e] = p * m;
    } else {
      dpt[e] = p * (dpt[e] * prm.scale - delta_s[col]);
      st[e] = p;
    }
  }
}

// ---- K2: dq ------------------------------------------------------------------------

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tma_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const BwdParams prm) {
  using T = DqTiles<D>;
  constexpr int BK = T::kBlockK;
  constexpr int S = T::kStages;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_smem = q_smem + T::kQBytes;
  const uint32_t stages = do_smem + T::kQBytes;  // stage s: k slabs, then v slabs
  const uint32_t full = q_smem + T::kBarriers;   // full[s] = full + 8 s
  const uint32_t empty = full + 8 * S;           // empty[s] = empty + 8 s
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, 2 * T::kQBytes);
#pragma unroll
      for (int j = 0; j < T::kSlabs; ++j) {
        tma_load(q_smem + j * kBlockQ * 128, &q_map, q_full, j * kSlab, h, q0, b);
        tma_load(do_smem + j * kBlockQ * 128, &do_map, q_full, j * kSlab, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);  // the first S pass at once
        const uint32_t k_smem = stages + s * T::kStageBytes;
        mbar_expect_tx(full + 8 * s, T::kStageBytes);
#pragma unroll
        for (int j = 0; j < T::kSlabs; ++j) {
          tma_load(k_smem + j * BK * 128, &k_map, full + 8 * s, j * kSlab, h, i * BK, b);
          tma_load(k_smem + T::kKBytes + j * BK * 128, &v_map, full + 8 * s, j * kSlab, h,
                   i * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // accumulator row (and row + 8) within the warp
    const int t = lane & 3;   // accumulator column pair
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;
    const uint32_t q_rows = q_smem + wg * 64 * 128;  // this warpgroup's rows of slab 0
    const uint32_t do_rows = do_smem + wg * 64 * 128;

    float lse[2], delta_s[2];  // delta_s: delta times the softmax scale
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      lse[r] = qi < prm.n_q ? prm.lse[(int64_t)bh * prm.n_q + qi] : 0.f;
      delta_s[r] = qi < prm.n_q ? prm.delta[(int64_t)bh * prm.n_q + qi] * prm.scale : 0.f;
    }
    float s[BK / 2];
    float dp[BK / 2];
    float acc[D / 2];
    uint32_t ds[BK / 16][4];
    uint32_t dropped[BK / 64];  // kDropout: the tile's drop flags (drop_bits)
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const uint32_t k_smem = stages + (i % S) * T::kStageBytes;
      mbar_wait(full + 8 * (i % S), (i / S) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D, BK>(s, q_rows, k_smem);
      issue_scores<D, BK>(dp, do_rows, k_smem + T::kKBytes);
      if constexpr (kDropout) drop_bits<BK>(dropped, row, i * BK, t, bh, prm.drop);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dq_score_grads<BK, kDropout>(s, dp, lse, delta_s, dropped, i * BK, t, prm);
      pack_p<BK>(ds, s);
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
      issue_values<D, BK>(acc, ds, k_smem);  // dq += ds k
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * (i % S));
    }
    store_tile_rows<D>(prm.out0, acc, b, h, prm.heads, prm.n_q, row, t);
  }
}

// ---- K3: dk and dv ------------------------------------------------------------------

template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tma_wgmma(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap do_map, const BwdParams prm) {
  using T = DkvTiles<D>;
  constexpr int BQ = T::kBlockQ2;
  constexpr int S = T::kStages;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_smem = (base + 1023u) & ~1023u;
  const uint32_t v_smem = k_smem + T::kKBytes;
  const uint32_t stages = v_smem + T::kKBytes;  // stage s: q slabs, then do slabs
  // stage s's lse [BQ], then delta [BQ]
  float* const rows = reinterpret_cast<float*>(smem_raw + (k_smem - base) + T::kRowsAt);
  const uint32_t full = k_smem + T::kBarriers;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * S;          // empty[s] = empty + 8 s
  const uint32_t kv_full = empty + 8 * S;

  const int bh = blockIdx.y;
  const int b = bh / prm.heads;
  const int h = bh % prm.heads;
  const int k0 = blockIdx.x * kBlockKey;
  const int n_tiles = (prm.n_q + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1 + 32);             // expect_tx, then the producer warp's rows
      mbar_init(empty + 8 * s, 128 * kConsumers);  // every consumer thread
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one warp keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (threadIdx.x < 128 * kConsumers + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::kKBytes);
#pragma unroll
        for (int j = 0; j < T::kSlabs; ++j) {
          tma_load(k_smem + j * kBlockKey * 128, &k_map, kv_full, j * kSlab, h, k0, b);
          tma_load(v_smem + j * kBlockKey * 128, &v_map, kv_full, j * kSlab, h, k0, b);
        }
      }
      const float* lse = prm.lse + (int64_t)bh * prm.n_q;
      const float* delta = prm.delta + (int64_t)bh * prm.n_q;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);  // the first S pass at once
        if (lane == 0) {
          const uint32_t q_smem = stages + s * T::kStageBytes;
          mbar_expect_tx(full + 8 * s, T::kStageBytes);
#pragma unroll
          for (int j = 0; j < T::kSlabs; ++j) {
            tma_load(q_smem + j * BQ * 128, &q_map, full + 8 * s, j * kSlab, h, i * BQ, b);
            tma_load(q_smem + T::kQBytes + j * BQ * 128, &do_map, full + 8 * s, j * kSlab, h,
                     i * BQ, b);
          }
        }
        float* r = rows + s * 2 * BQ;
#pragma unroll
        for (int j = lane; j < BQ; j += 32) {
          const int qi = i * BQ + j;
          r[j] = qi < prm.n_q ? lse[qi] : INFINITY;  // p = 0 past n_q
          r[BQ + j] = qi < prm.n_q ? delta[qi] * prm.scale : 0.f;
        }
        mbar_arrive(full + 8 * s);  // releases this lane's rows
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key_row = k0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;
    const uint32_t k_rows = k_smem + wg * 64 * 128;  // this warpgroup's rows of slab 0
    const uint32_t v_rows = v_smem + wg * 64 * 128;

    float st[BQ / 2];
    float dpt[BQ / 2];
    float dk[D / 2];
    float dv[D / 2];
    uint32_t pf[BQ / 16][4];
    uint32_t dsf[BQ / 16][4];
    uint32_t dropped[BQ / 64];  // kDropout: the tile's drop flags (drop_bits_t)
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const uint32_t q_smem = stages + (i % S) * T::kStageBytes;
      mbar_wait(full + 8 * (i % S), (i / S) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      issue_scores<D, BQ>(st, k_rows, q_smem);                // s^T = k q^T
      issue_scores<D, BQ>(dpt, v_rows, q_smem + T::kQBytes);  // dp^T = v do^T
      if (kDropout && (!T::kDrawLate || i == 0))
        drop_bits_t<BQ>(dropped, key_row, i * BQ, g, t, bh, prm.drop);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      dkv_score_grads<BQ, kDropout>(st, dpt, dropped, rows + (i % S) * 2 * BQ, t, prm);
      pack_p<BQ>(pf, st);
      pack_p<BQ>(dsf, dpt);
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      wgmma_fence();
      issue_values<D, BQ>(dv, pf, q_smem + T::kQBytes);  // dv += (p m)^T do
      issue_values<D, BQ>(dk, dsf, q_smem);              // dk += ds^T q
      if (kDropout && T::kDrawLate && i + 1 < n_tiles)
        drop_bits_t<BQ>(dropped, key_row, (i + 1) * BQ, g, t, bh, prm.drop);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + 8 * (i % S));
    }
    store_tile_rows<D>(prm.out0, dk, b, h, prm.heads, prm.n_k, key_row, t);
    store_tile_rows<D>(prm.out1, dv, b, h, prm.heads, prm.n_k, key_row, t);
  }
}

// ---- host side --------------------------------------------------------------------

// Encodes the maps of q, k, v and do (element strides {b, n, h} each, in
// that order in `strides`) and launches K2 over ceil(N_q / 128) x B*H
// blocks. Returns 0, a cudaError_t code, or kEncodeFailed.
template <int D, bool kDropout>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const int64_t* strides, int64_t batch, const BwdParams& prm, cudaStream_t stream) {
  using T = DqTiles<D>;
  CUtensorMap maps[4];  // q, do, k, v
  const void* bases[4] = {q, dout, k, v};
  const int64_t* st[4] = {strides, strides + 9, strides + 3, strides + 6};
  const int64_t n[4] = {prm.n_q, prm.n_q, prm.n_k, prm.n_k};
  const int box[4] = {kBlockQ, kBlockQ, T::kBlockK, T::kBlockK};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!encode_map(&maps[i], bases[i], D, prm.heads, n[i], batch, st[i], box[i]))
      return kEncodeFailed;
  }
  const auto kernel = flash_bwd_dq_tma_wgmma<D, kDropout>;
  // at every launch: the limit belongs to the function in the current device's context
  const cudaError_t allowed = allow_smem(kernel, T::kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((prm.n_q + kBlockQ - 1) / kBlockQ), (unsigned)(batch * prm.heads));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
  return (int)cudaGetLastError();
}

// The same for K3 over ceil(N_k / 128) x B*H blocks.
template <int D, bool kDropout>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const int64_t* strides, int64_t batch, const BwdParams& prm, cudaStream_t stream) {
  using T = DkvTiles<D>;
  CUtensorMap maps[4];  // k, v, q, do
  const void* bases[4] = {k, v, q, dout};
  const int64_t* st[4] = {strides + 3, strides + 6, strides, strides + 9};
  const int64_t n[4] = {prm.n_k, prm.n_k, prm.n_q, prm.n_q};
  const int box[4] = {kBlockKey, kBlockKey, T::kBlockQ2, T::kBlockQ2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!encode_map(&maps[i], bases[i], D, prm.heads, n[i], batch, st[i], box[i]))
      return kEncodeFailed;
  }
  const auto kernel = flash_bwd_dkv_tma_wgmma<D, kDropout>;
  const cudaError_t allowed = allow_smem(kernel, T::kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((prm.n_k + kBlockKey - 1) / kBlockKey), (unsigned)(batch * prm.heads));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
  return (int)cudaGetLastError();
}

}  // namespace hopper
}  // namespace orbit2

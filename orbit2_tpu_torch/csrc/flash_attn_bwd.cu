// Flash-attention backward, non-causal: two kernels, as in FlashAttention-2
// and the TPU package.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (orbit2_tpu/ops/flash_attention.py:287-375, called from `_flash_bwd` at
// :386 and :410). With s = q k^T * scale * log2(e), p = exp2(s - lse) (the
// forward's base-2 lse, fp32 [B*H, N_q]), dp = do v^T, delta = rowsum(o do)
// (computed by the caller, as the TPU wrapper does at :383) and the dropout
// multiplier m in {0, 1/keep} (1 without dropout):
//
//   dq = sum_kv ds k,   ds = p * (dp * m - delta) * scale      (dq kernel)
//   dv = sum_q (p * m)^T do,   dk = sum_q ds^T q               (dk/dv kernel)
//
// The dq kernel owns one (batch*head, query tile) and streams k/v tiles; the
// dk/dv kernel owns one (batch*head, key tile) and streams q/do tiles. Each
// block writes only its own rows: no atomics, so dq, dk and dv are bit-equal
// from run to run. Both recompute the scores with the forward's scale
// (sm_scale * log2(e) rounded to fp32) and regenerate the forward's dropout
// mask from (seed, batch*head, query, key) (csrc/kernel_prng.cuh), whatever
// their tiling. Ragged N_q and N_k are masked in the kernel (zero-filled tile
// rows, p = 0 past N_k, rows past the end not stored). dq/dk/dv are written
// contiguous [B, N, H, D] in the input dtype.
//
// What bounds it on the H100: the backward does 2.5x the forward's matrix
// work (five products of N_q x N_k x D per head, against two; seven as two
// kernels, which both recompute s and dp), so the matrix units, and with
// dropout the Philox calls (one per 4 scores in each kernel).
//   * bf16, D = 64 and 128: flash_bwd_dq_tma_wgmma and
//     flash_bwd_dkv_tma_wgmma of flash_bwd_hopper.cuh, K1's design (TMA
//     ring, one producer warp, two consumer warpgroups on wgmma, dropout
//     bits in registers). Its header says how they are laid out.
//   * bf16, D = 256: mma.sync m16n8k16 (bf16 in, fp32 accumulate), whose
//     dk and dv would take 256 registers a thread in the wgmma layout. Each
//     warp holds 16 rows of the score tile in registers, turns them into ds
//     (dq) or p*m and ds (dk/dv) in place, and feeds them as the A operand
//     of the next product; the B operands whose k index runs down a tile's
//     rows are gathered as two 16-bit loads per register. The block runs
//     four groups of 4 warps, each recomputing the scores and owning 64 of
//     the output columns (2.5x the matrix work); the mask goes through a
//     byte tile in shared memory.
//   * fp32: the tensor cores have no full-fp32 mode, so 8 threads per row do
//     the products with fp32 FMAs on 32 x 32 tiles (four fp32 tiles of D = 256
//     fit the 227 KB of shared memory at that size); p and ds go through
//     shared memory. Exact to fp32 rounding and bound by shared-memory
//     bandwidth.

#include "flash_bwd_hopper.cuh"
#include "flash_common.cuh"

namespace {

using orbit2::bf16;
using orbit2::Dropout;
using orbit2::ld_pair_rows;
using orbit2::mma_16816;
using orbit2::pack_bf16x2;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, N_q]
  const float* delta;  // [B*H, N_q]
  void* dq;
  void* dk;
  void* dv;
  int heads, n_q, n_k;
  int64_t batch;
  // element strides {b, n, h} of q, k, v and do
  int64_t sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh;
  const int64_t* strides;  // the same twelve, for the TMA maps
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e), as the forward rounds it
  Dropout drop;
  cudaStream_t stream;
};

// ---- bf16 at D = 256: tensor cores (mma.sync m16n8k16) ---------------------
// The wrapper's bf16 operands follow TMA's alignment rule
// (ops/flash_attention.py::tma_operands), so every row starts 16-byte
// aligned and the tiles load 8 elements at a time.

constexpr int kBlock = 64;            // query and key tile rows
constexpr int kKeepLd = kBlock + 4;   // byte row stride of the keep tile
constexpr int kGroupCols = 64;        // output columns of one group of 4 warps

template <int D>
struct Mma {
  static constexpr int kGroups = D / kGroupCols;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kLd = D + 8;  // [row][d] bf16 tiles: conflict-free fragment loads
  static constexpr size_t kTile = sizeof(bf16) * kBlock * kLd;
  static constexpr size_t kKeep = (size_t)kBlock * kKeepLd;
};

// acc[j] += x b over the tile's 64 rows, where x (16 x 64) is held in the
// accumulator layout of a score tile and b is a [row][d] tile: acc[j] is the
// 16x8 output tile of columns d0 + 8j .. d0 + 8j + 7.
template <int D>
__device__ __forceinline__ void regs_times_rows(float (&acc)[kGroupCols / 8][4],
                                                const float (&x)[kBlock / 8][4], const bf16* b,
                                                int d0, int g, int t) {
  constexpr int kLd = Mma<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < kGroupCols / 8; ++j) {
      const bf16* pb = b + (kk * 16 + 2 * t) * kLd + d0 + j * 8 + g;
      const uint32_t bf[2] = {ld_pair_rows(pb, kLd), ld_pair_rows(pb + 8 * kLd, kLd)};
      mma_16816(acc[j], af, bf);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// Writes one warp's 16 x 64 output slice (rows row0 + r0 .., columns d0 ..)
// to a contiguous [B, N, H, D] tensor.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[kGroupCols / 8][4],
                                           int b, int h, int heads, int n, int row0, int r0,
                                           int d0, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r0 + g + 8 * r;
    if (i < n) {
      bf16* orow = out + (((int64_t)b * n + i) * heads + h) * D + d0 + 2 * t;
#pragma unroll
      for (int j = 0; j < kGroupCols / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16x2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(Mma<D>::kThreads) dq_mma_kernel(Args a) {
  using L = Mma<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBlock * L::kLd;
  bf16* ks = dos + kBlock * L::kLd;
  bf16* vs = ks + kBlock * L::kLd;
  uint8_t* keep = reinterpret_cast<uint8_t*>(vs + kBlock * L::kLd);  // kDropout only

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = (warp % 4) * 16;
  const int d0 = (warp / 4) * kGroupCols;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.skb + h * a.skh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.svb + h * a.svh;
  orbit2::load_bf16_rows<D, kBlock, L::kThreads>(
      qs, L::kLd, static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh, a.sqn, q0, a.n_q);
  orbit2::load_bf16_rows<D, kBlock, L::kThreads>(
      dos, L::kLd, static_cast<const bf16*>(a.dout) + b * a.sob + h * a.soh, a.son, q0, a.n_q);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    lse[r] = qi < a.n_q ? a.lse[(int64_t)bh * a.n_q + qi] : 0.f;
    delta[r] = qi < a.n_q ? a.delta[(int64_t)bh * a.n_q + qi] : 0.f;
  }

  float acc[kGroupCols / 8][4];
  zero(acc);
  for (int k0 = 0; k0 < a.n_k; k0 += kBlock) {
    __syncthreads();  // the previous tile's reads are done
    orbit2::load_bf16_rows<D, kBlock, L::kThreads>(ks, L::kLd, kb, a.skn, k0, a.n_k);
    orbit2::load_bf16_rows<D, kBlock, L::kThreads>(vs, L::kLd, vb, a.svn, k0, a.n_k);
    if constexpr (kDropout) {
      orbit2::fill_keep_tile<kBlock, kBlock, L::kThreads>(keep, kKeepLd, a.drop.seed, bh, q0, k0,
                                                          a.drop.threshold);
    }
    __syncthreads();

    float s[kBlock / 8][4], dp[kBlock / 8][4];
    orbit2::tile_scores<D, kBlock>(s, qs, L::kLd, ks, L::kLd, r0, g, t);  // the forward's product
    orbit2::tile_scores<D, kBlock>(dp, dos, L::kLd, vs, L::kLd, r0, g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + 2 * t + (e & 1);
        const float p = k0 + cl < a.n_k ? exp2f(s[j][e] * a.scale_log2 - lse[e >> 1]) : 0.f;
        float d = dp[j][e];
        if constexpr (kDropout) {
          d *= keep[(r0 + g + 8 * (e >> 1)) * kKeepLd + cl] ? a.drop.scale : 0.f;
        }
        s[j][e] = p * (d - delta[e >> 1]) * a.scale;  // ds
      }
    }
    regs_times_rows<D>(acc, s, ks, d0, g, t);
  }
  store_rows<D>(static_cast<bf16*>(a.dq), acc, b, h, a.heads, a.n_q, q0, r0, d0, g, t);
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(Mma<D>::kThreads) dkv_mma_kernel(Args a) {
  using L = Mma<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBlock * L::kLd;
  bf16* qs = vs + kBlock * L::kLd;
  bf16* dos = qs + kBlock * L::kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBlock * L::kLd);
  float* delta_s = lse_s + kBlock;
  uint8_t* keep = reinterpret_cast<uint8_t*>(delta_s + kBlock);  // kDropout only

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int k0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = (warp % 4) * 16;
  const int d0 = (warp / 4) * kGroupCols;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.sob + h * a.soh;
  orbit2::load_bf16_rows<D, kBlock, L::kThreads>(
      ks, L::kLd, static_cast<const bf16*>(a.k) + b * a.skb + h * a.skh, a.skn, k0, a.n_k);
  orbit2::load_bf16_rows<D, kBlock, L::kThreads>(
      vs, L::kLd, static_cast<const bf16*>(a.v) + b * a.svb + h * a.svh, a.svn, k0, a.n_k);

  float dk[kGroupCols / 8][4], dv[kGroupCols / 8][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.n_q; q0 += kBlock) {
    __syncthreads();  // the previous tile's reads are done
    orbit2::load_bf16_rows<D, kBlock, L::kThreads>(qs, L::kLd, qb, a.sqn, q0, a.n_q);
    orbit2::load_bf16_rows<D, kBlock, L::kThreads>(dos, L::kLd, ob, a.son, q0, a.n_q);
    for (int i = threadIdx.x; i < kBlock; i += L::kThreads) {
      const bool valid = q0 + i < a.n_q;
      lse_s[i] = valid ? a.lse[(int64_t)bh * a.n_q + q0 + i] : 0.f;
      delta_s[i] = valid ? a.delta[(int64_t)bh * a.n_q + q0 + i] : 0.f;
    }
    if constexpr (kDropout) {  // rows are queries, columns keys, as in the forward
      orbit2::fill_keep_tile<kBlock, kBlock, L::kThreads>(keep, kKeepLd, a.drop.seed, bh, q0, k0,
                                                          a.drop.threshold);
    }
    __syncthreads();

    // transposed scores: rows are this warp's keys, columns the tile's queries
    float st[kBlock / 8][4], dpt[kBlock / 8][4];
    orbit2::tile_scores<D, kBlock>(st, ks, L::kLd, qs, L::kLd, r0, g, t);
    orbit2::tile_scores<D, kBlock>(dpt, vs, L::kLd, dos, L::kLd, r0, g, t);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        const float p = q0 + ql < a.n_q ? exp2f(st[j][e] * a.scale_log2 - lse_s[ql]) : 0.f;
        float pm = p, d = dpt[j][e];
        if constexpr (kDropout) {
          const float m = keep[ql * kKeepLd + r0 + g + 8 * (e >> 1)] ? a.drop.scale : 0.f;
          pm *= m;
          d *= m;
        }
        st[j][e] = pm;                                    // (p * m)^T
        dpt[j][e] = p * (d - delta_s[ql]) * a.scale;      // ds^T
      }
    }
    regs_times_rows<D>(dv, st, dos, d0, g, t);
    regs_times_rows<D>(dk, dpt, qs, d0, g, t);
  }
  store_rows<D>(static_cast<bf16*>(a.dk), dk, b, h, a.heads, a.n_k, k0, r0, d0, g, t);
  store_rows<D>(static_cast<bf16*>(a.dv), dv, b, h, a.heads, a.n_k, k0, r0, d0, g, t);
}

// ---- fp32: FMAs ------------------------------------------------------------

constexpr int kFBlock = 32;                          // query and key tile rows
constexpr int kFRow = 8;                             // threads per row
constexpr int kFThreads = kFBlock * kFRow;           // 256
constexpr int kFCols = kFBlock / kFRow;              // score columns per thread
constexpr int kFKeepLd = kFBlock + 4;
constexpr int kFLdP = kFBlock + 1;

template <int D>
struct Fma {
  static constexpr int kLd = D + 1;  // one word of padding: conflict-free reads
  static constexpr int kOut = D / kFRow;  // output columns per thread
  static constexpr size_t kTile = sizeof(float) * kFBlock * kLd;
  static constexpr size_t kScores = sizeof(float) * kFBlock * kFLdP;
};

// s = dot(x, y) over D as one fmaf chain in the forward's order
template <int D>
__device__ __forceinline__ float dot_fma(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) s = fmaf(x[c], y[c], s);
  return s;
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kFThreads) dq_fma_kernel(Args a) {
  using L = Fma<D>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kFBlock * L::kLd;
  float* ks = dos + kFBlock * L::kLd;
  float* vs = ks + kFBlock * L::kLd;
  float* dss = vs + kFBlock * L::kLd;
  uint8_t* keep = reinterpret_cast<uint8_t*>(dss + kFBlock * kFLdP);  // kDropout only

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kFBlock;
  const int row = threadIdx.x / kFRow;
  const int sub = threadIdx.x % kFRow;
  const int qi = q0 + row;

  const float* kb = static_cast<const float*>(a.k) + b * a.skb + h * a.skh;
  const float* vb = static_cast<const float*>(a.v) + b * a.svb + h * a.svh;
  orbit2::load_f32_rows<D, kFBlock, kFThreads>(
      qs, L::kLd, static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh, a.sqn, q0, a.n_q);
  orbit2::load_f32_rows<D, kFBlock, kFThreads>(
      dos, L::kLd, static_cast<const float*>(a.dout) + b * a.sob + h * a.soh, a.son, q0, a.n_q);
  const float lse = qi < a.n_q ? a.lse[(int64_t)bh * a.n_q + qi] : 0.f;
  const float delta = qi < a.n_q ? a.delta[(int64_t)bh * a.n_q + qi] : 0.f;

  float acc[L::kOut];
#pragma unroll
  for (int i = 0; i < L::kOut; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < a.n_k; k0 += kFBlock) {
    __syncthreads();  // the previous tile's reads are done
    orbit2::load_f32_rows<D, kFBlock, kFThreads>(ks, L::kLd, kb, a.skn, k0, a.n_k);
    orbit2::load_f32_rows<D, kFBlock, kFThreads>(vs, L::kLd, vb, a.svn, k0, a.n_k);
    if constexpr (kDropout) {
      orbit2::fill_keep_tile<kFBlock, kFBlock, kFThreads>(keep, kFKeepLd, a.drop.seed, bh, q0,
                                                          k0, a.drop.threshold);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kFCols; ++j) {
      const int cl = sub + kFRow * j;
      const float s = dot_fma<D>(qs + row * L::kLd, ks + cl * L::kLd);
      float dp = dot_fma<D>(dos + row * L::kLd, vs + cl * L::kLd);
      const float p = k0 + cl < a.n_k ? exp2f(s * a.scale_log2 - lse) : 0.f;
      if constexpr (kDropout) dp *= keep[row * kFKeepLd + cl] ? a.drop.scale : 0.f;
      dss[row * kFLdP + cl] = p * (dp - delta) * a.scale;
    }
    __syncthreads();  // the whole row of ds is in shared memory
#pragma unroll 2
    for (int kv = 0; kv < kFBlock; ++kv) {
      const float ds = dss[row * kFLdP + kv];
      const float* krow = ks + kv * L::kLd + sub;
#pragma unroll
      for (int i = 0; i < L::kOut; ++i) acc[i] = fmaf(ds, krow[kFRow * i], acc[i]);
    }
  }
  if (qi < a.n_q) {
    float* out = static_cast<float*>(a.dq) + (((int64_t)b * a.n_q + qi) * a.heads + h) * D + sub;
#pragma unroll
    for (int i = 0; i < L::kOut; ++i) out[kFRow * i] = acc[i];
  }
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kFThreads) dkv_fma_kernel(Args a) {
  using L = Fma<D>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kFBlock * L::kLd;
  float* qs = vs + kFBlock * L::kLd;
  float* dos = qs + kFBlock * L::kLd;
  float* pts = dos + kFBlock * L::kLd;   // (p * m)^T [key][query]
  float* dsts = pts + kFBlock * kFLdP;   // ds^T [key][query]
  float* lse_s = dsts + kFBlock * kFLdP;
  float* delta_s = lse_s + kFBlock;
  uint8_t* keep = reinterpret_cast<uint8_t*>(delta_s + kFBlock);  // kDropout only

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int k0 = blockIdx.x * kFBlock;
  const int row = threadIdx.x / kFRow;  // key row of the tile
  const int sub = threadIdx.x % kFRow;

  const float* qb = static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh;
  const float* ob = static_cast<const float*>(a.dout) + b * a.sob + h * a.soh;
  orbit2::load_f32_rows<D, kFBlock, kFThreads>(
      ks, L::kLd, static_cast<const float*>(a.k) + b * a.skb + h * a.skh, a.skn, k0, a.n_k);
  orbit2::load_f32_rows<D, kFBlock, kFThreads>(
      vs, L::kLd, static_cast<const float*>(a.v) + b * a.svb + h * a.svh, a.svn, k0, a.n_k);

  float dk[L::kOut], dv[L::kOut];
#pragma unroll
  for (int i = 0; i < L::kOut; ++i) dk[i] = dv[i] = 0.f;
  for (int q0 = 0; q0 < a.n_q; q0 += kFBlock) {
    __syncthreads();  // the previous tile's reads are done
    orbit2::load_f32_rows<D, kFBlock, kFThreads>(qs, L::kLd, qb, a.sqn, q0, a.n_q);
    orbit2::load_f32_rows<D, kFBlock, kFThreads>(dos, L::kLd, ob, a.son, q0, a.n_q);
    for (int i = threadIdx.x; i < kFBlock; i += kFThreads) {
      const bool valid = q0 + i < a.n_q;
      lse_s[i] = valid ? a.lse[(int64_t)bh * a.n_q + q0 + i] : 0.f;
      delta_s[i] = valid ? a.delta[(int64_t)bh * a.n_q + q0 + i] : 0.f;
    }
    if constexpr (kDropout) {  // rows are queries, columns keys, as in the forward
      orbit2::fill_keep_tile<kFBlock, kFBlock, kFThreads>(keep, kFKeepLd, a.drop.seed, bh, q0,
                                                          k0, a.drop.threshold);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kFCols; ++j) {
      const int ql = sub + kFRow * j;
      const float s = dot_fma<D>(qs + ql * L::kLd, ks + row * L::kLd);
      float dp = dot_fma<D>(dos + ql * L::kLd, vs + row * L::kLd);
      const float p = q0 + ql < a.n_q ? exp2f(s * a.scale_log2 - lse_s[ql]) : 0.f;
      float pm = p;
      if constexpr (kDropout) {
        const float m = keep[ql * kFKeepLd + row] ? a.drop.scale : 0.f;
        pm *= m;
        dp *= m;
      }
      pts[row * kFLdP + ql] = pm;
      dsts[row * kFLdP + ql] = p * (dp - delta_s[ql]) * a.scale;
    }
    __syncthreads();  // the whole row of p and ds is in shared memory
#pragma unroll 2
    for (int qr = 0; qr < kFBlock; ++qr) {
      const float pm = pts[row * kFLdP + qr];
      const float ds = dsts[row * kFLdP + qr];
      const float* dorow = dos + qr * L::kLd + sub;
      const float* qrow = qs + qr * L::kLd + sub;
#pragma unroll
      for (int i = 0; i < L::kOut; ++i) {
        dv[i] = fmaf(pm, dorow[kFRow * i], dv[i]);
        dk[i] = fmaf(ds, qrow[kFRow * i], dk[i]);
      }
    }
  }
  const int ki = k0 + row;
  if (ki < a.n_k) {
    const int64_t at = (((int64_t)b * a.n_k + ki) * a.heads + h) * D + sub;
    float* dko = static_cast<float*>(a.dk) + at;
    float* dvo = static_cast<float*>(a.dv) + at;
#pragma unroll
    for (int i = 0; i < L::kOut; ++i) {
      dko[kFRow * i] = dk[i];
      dvo[kFRow * i] = dv[i];
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kernel, int rows, int block, int threads, size_t smem, const Args& a) {
  cudaError_t err = orbit2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((rows + block - 1) / block), (unsigned)(a.batch * a.heads));
  kernel<<<grid, threads, smem, a.stream>>>(a);
  return (int)cudaGetLastError();
}

// dq (the dq kernel) or dk and dv (the dk/dv kernel) of the Hopper kernels
orbit2::hopper::BwdParams hopper_params(const Args& a) {
  return {static_cast<bf16*>(a.dq != nullptr ? a.dq : a.dk), static_cast<bf16*>(a.dv), a.lse,
          a.delta, a.heads, a.n_q, a.n_k, a.scale, a.scale_log2, a.drop};
}

template <int D, bool kDropout>
int launch_dq(int dtype, const Args& a) {
  if (dtype == 1) {
    if constexpr (D != 256) {
      return orbit2::hopper::launch_dq<D, kDropout>(a.q, a.k, a.v, a.dout, a.strides, a.batch,
                                                    hopper_params(a), a.stream);
    } else {
      using L = Mma<D>;
      return launch_kernel(dq_mma_kernel<D, kDropout>, a.n_q, kBlock, L::kThreads,
                           4 * L::kTile + (kDropout ? L::kKeep : 0), a);
    }
  }
  using L = Fma<D>;
  return launch_kernel(dq_fma_kernel<D, kDropout>, a.n_q, kFBlock, kFThreads,
                       4 * L::kTile + L::kScores + (kDropout ? kFBlock * kFKeepLd : 0), a);
}

template <int D, bool kDropout>
int launch_dkv(int dtype, const Args& a) {
  if (dtype == 1) {
    if constexpr (D != 256) {
      return orbit2::hopper::launch_dkv<D, kDropout>(a.q, a.k, a.v, a.dout, a.strides, a.batch,
                                                     hopper_params(a), a.stream);
    } else {
      using L = Mma<D>;
      return launch_kernel(dkv_mma_kernel<D, kDropout>, a.n_k, kBlock, L::kThreads,
                           4 * L::kTile + 2 * kBlock * sizeof(float) +
                               (kDropout ? L::kKeep : 0),
                           a);
    }
  }
  using L = Fma<D>;
  return launch_kernel(dkv_fma_kernel<D, kDropout>, a.n_k, kFBlock, kFThreads,
                       4 * L::kTile + 2 * L::kScores + 2 * kFBlock * sizeof(float) +
                           (kDropout ? kFBlock * kFKeepLd : 0),
                       a);
}

template <int D>
int launch(bool dkv, int dtype, const Args& a, bool dropout) {
  if (dkv) return dropout ? launch_dkv<D, true>(dtype, a) : launch_dkv<D, false>(dtype, a);
  return dropout ? launch_dq<D, true>(dtype, a) : launch_dq<D, false>(dtype, a);
}

int dispatch(bool dkv, int dtype, int64_t head_dim, const Args& a, int dropout) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (head_dim) {
    case 64: return launch<64>(dkv, dtype, a, dropout != 0);
    case 128: return launch<128>(dkv, dtype, a, dropout != 0);
    case 256: return launch<256>(dkv, dtype, a, dropout != 0);
  }
  return -1;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int64_t batch, int64_t heads,
               int64_t n_q, int64_t n_k, const int64_t* s, double sm_scale,
               uint64_t seed, uint32_t drop_threshold, float drop_scale, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              dq, dk, dv, (int)heads, (int)n_q, (int)n_k, batch,
              s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], s,
              (float)sm_scale, (float)(sm_scale * 1.4426950408889634),
              Dropout{seed, drop_threshold, drop_scale}, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: {b, n, h} element strides of q, k, v and do (12 values); lse and
// delta are contiguous fp32 [B*H, N_q]; dq [B, N_q, H, D] and dk/dv
// [B, N_k, H, D] are written contiguous. For bf16 the base pointers must be
// 16-byte aligned and the strides multiples of 8 (TMA's rule; the wrapper
// copies an operand that breaks it). dropout, seed, drop_threshold and
// drop_scale are the forward's. Each returns 0 on success, a cudaError_t
// code if the launch failed, -1 for a dtype or head dim it has no instance
// for, or -2 when the driver refuses a bf16 operand's tensor map.
extern "C" int orbit2_flash_attn_bwd_dq(int dtype, int64_t head_dim, const void* q,
                                        const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, void* dq,
                                        int64_t batch, int64_t heads, int64_t n_q, int64_t n_k,
                                        const int64_t* strides, double sm_scale,
                                        int dropout, uint64_t seed, uint32_t drop_threshold,
                                        float drop_scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, heads, n_q,
                           n_k, strides, sm_scale, seed, drop_threshold, drop_scale, stream);
  return dispatch(false, dtype, head_dim, a, dropout);
}

extern "C" int orbit2_flash_attn_bwd_dkv(int dtype, int64_t head_dim, const void* q,
                                         const void* k, const void* v, const void* dout,
                                         const void* lse, const void* delta, void* dk, void* dv,
                                         int64_t batch, int64_t heads, int64_t n_q, int64_t n_k,
                                         const int64_t* strides, double sm_scale,
                                         int dropout, uint64_t seed, uint32_t drop_threshold,
                                         float drop_scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, batch, heads, n_q, n_k,
                           strides, sm_scale, seed, drop_threshold, drop_scale, stream);
  return dispatch(true, dtype, head_dim, a, dropout);
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

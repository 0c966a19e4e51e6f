// Fused transformer MLP for Hopper (sm_90a): out = drop2(drop1(gelu(x W1^T + b1)) W2^T + b2)
// and its backward.
//
// Replaces the Pallas TPU kernels of orbit2_tpu/ops/fused_mlp.py:
//   * `_fwd_kernel` (:125, called at :154)  -> bf16: F1 and F2 of
//     fused_mlp_hopper.cuh; fp32: fused_mlp_fwd_kernel
//   * `_dx_kernel`  (:177, called at :363)  -> bf16: stage H and dx of
//     fused_mlp_hopper.cuh; fp32: fused_mlp_dx_kernel
//   * `_dw_kernel`  (:209, called at :386)  -> bf16: stage H, db2's partials
//     and dW of fused_mlp_hopper.cuh; fp32: fused_mlp_dw_kernel
//
// Layout: x [T, D] and the output gradient do [T, D2] row-major; the weights
// as PyTorch's Linear stores them, W1 [F, D] and W2 [D2, F], read as stored
// (no transposed copy per call); b1 [F], b2 [D2]. One dtype for all of them:
// bf16 or fp32. T is any multiple of 8 (ragged T tiles are zero-filled and
// masked); D, F and D2 are multiples of 128.
//
// Rounding points are the TPU kernels': fp32 accumulation; the hidden h
// rounded to the input dtype before the second product (:139); + b2 and the
// output mask in fp32, then one rounding (:144-147). Backward: do2 = do * m2
// rounded to the dtype (:184-187); dh = do2 W2 (fp32) times m1; dpre = dh *
// gelu'(h_pre); dx = dpre_r W1; dW2 = do2^T h_r; dW1 = dpre_r^T x (r =
// rounded to the dtype); db1 = sum_t dpre and db2 = sum_t do * m2 in fp32,
// unrounded. GELU and its derivative are evaluated in fp32: by the TPU's
// Abramowitz-Stegun erf (:57-65) in the bf16 kernels, by CUDA's erff in the
// fp32 ones.
//
// Dropout (the kDrop instances; rate 0 compiles to kernels without it): the
// multiplier of hidden element (t, f) is that of csrc/kernel_prng.cuh at
// (seed1, stream 0, row t, col f) and of output element (t, n) at (seed2, 0,
// t, n), one Philox call per 8 columns: exactly the bits the fused dropout
// (fused_dropout.cu) draws for the unfused Mlp's two dropouts under the same
// seeds, and independent of tiles (the TPU's 256-unit mask grid, :81-119, has
// no counterpart).
//
// The bf16 kernels are fused_mlp_hopper.cuh's: the forward writes the
// hidden h_r once into a bf16 [T, F] workspace (F1) and multiplies it by W2
// (F2); the backward's stage H computes h_pre and dh once into a bf16
// workspace, then dx, dW1 and dW2 are plain-shaped TMA-fed wgmma products.
// The fp32 kernels here are the parity dtype, not a speed path: FMAs in the
// m16n8 accumulator layout, every block owning one output tile and
// recomputing what it needs, so they store no [T, F] tensor:
//   * forward: a (64 tokens, 256 output columns) tile; for each 64-wide
//     hidden chunk it computes h = x W1[chunk]^T (streaming D through shared
//     memory in 64-deep chunks), applies b1, GELU and m1, stores h into
//     shared memory and adds h W2[cols, chunk]^T to registers. x W1^T is
//     recomputed D2/256 times.
//   * dx: a (64 tokens, 256 columns of D) tile; per hidden chunk it
//     recomputes h_pre (depth D) and dh = do2 W2 (depth D2, do masked as it
//     is loaded), forms dpre in registers and adds dpre W1[chunk, cols].
//   * dW: two kinds of block in one grid. A (128 rows of D2, 128 of F) block
//     of dW2 recomputes h for each 64-token chunk and adds do2^T h; a (128 of
//     F, 128 of D) block of dW1 recomputes h_pre and dh and adds dpre^T x.
//     The F-column-0 blocks of the first kind also sum db2 and the
//     D-column-0 blocks of the second kind db1.
// Every sum over T runs in a fixed order inside one block (no atomics), so
// two runs give bit-equal gradients in both dtypes.

#include "flash_common.cuh"
#include "fused_mlp_hopper.cuh"

namespace {

using orbit2::bf16;
using orbit2::Dropout;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBT = 64;        // tokens per tile
constexpr int kBK = 64;        // depth of one streamed chunk
constexpr int kBF = 64;        // hidden chunk of the forward and dx blocks
constexpr int kBN = 256;       // output columns of a forward or dx block
constexpr int kBW = 128;       // edge of a dW tile

// Row stride of a shared fp32 tile of `cols` elements: 16 bytes of padding
// keeps the fragment reads free of bank conflicts and rows 16-byte aligned.
__host__ __device__ constexpr int ld_of(int cols) { return cols + 4; }

using orbit2::mlp::dgelu;
using orbit2::mlp::gelu;

// The drop flags of columns 8 (col / 8) .. + 7 of `row` (bit c for column
// 8 (col / 8) + c): one Philox call (kernel_prng.cuh).
__device__ __forceinline__ uint32_t drop_flags_at(const Dropout& d, int row, int col) {
  return orbit2::drop_flags8(d.seed, 0u, (uint32_t)row, (uint32_t)(col >> 3), d.threshold);
}

// The multipliers of elements (row, col) and (row, col + 1), col even.
__device__ __forceinline__ float2 keep_pair(const Dropout& d, int row, int col) {
  const uint32_t dropped = drop_flags_at(d, row, col) >> (col & 7);
  return make_float2((dropped & 1u) ? 0.f : d.scale, (dropped & 2u) ? 0.f : d.scale);
}

__device__ __forceinline__ float keep_one(const Dropout& d, int row, int col) {
  return ((drop_flags_at(d, row, col) >> (col & 7)) & 1u) ? 0.f : d.scale;
}

// Copies the [kRows, kCols] tile at (row0, col0) of a row-major global matrix
// (row stride src_ld) into shared memory, 16 bytes per step, zero-filling
// rows at or past n_rows and columns at or past n_cols. dst is [kRows][ld],
// or [kCols][ld] when kTrans (element (r, c) at dst[c * ld + r]). When kMask
// each element is multiplied by its multiplier at global (row, col).
template <int kRows, int kCols, bool kTrans, bool kMask>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int64_t src_ld, int row0, int col0, int n_rows,
                                          int n_cols, const Dropout& drop) {
  constexpr int kVec = 4;
  constexpr int kChunks = kCols / kVec;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    // transposed: consecutive threads take consecutive rows, so their stores
    // land in consecutive banks (one row per thread would put a warp's
    // stores, kVec * ld elements apart, into one bank)
    const int r = kTrans ? idx % kRows : idx / kChunks;
    const int c = (kTrans ? idx / kRows : idx % kChunks) * kVec;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && col0 + c < n_cols) {
      v = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * src_ld + col0 + c);
      if constexpr (kMask) {
        // one call covers the chunk's 4 columns (half of a call's 8)
        const uint32_t dropped = drop_flags_at(drop, row0 + r, col0 + c) >> ((col0 + c) & 7);
        v.x *= (dropped & 1u) ? 0.f : drop.scale;
        v.y *= (dropped & 2u) ? 0.f : drop.scale;
        v.z *= (dropped & 4u) ? 0.f : drop.scale;
        v.w *= (dropped & 8u) ? 0.f : drop.scale;
      }
    }
    if constexpr (kTrans) {
      dst[c * ld + r] = v.x;
      dst[(c + 1) * ld + r] = v.y;
      dst[(c + 2) * ld + r] = v.z;
      dst[(c + 3) * ld + r] = v.w;
    } else {
      *reinterpret_cast<float4*>(dst + r * ld + c) = v;
    }
  }
}

// c[j] += A B_j^T over `depth` for one warp, by FMAs: A is the warp's 16
// rows ([16][depth] at a, row stride lda), B_j rows 8j..8j+7 of b ([kNT *
// 8][depth], stride ldb). c[j] holds the m16n8 accumulator layout of
// flash_common.cuh's mma_16816: rows g, g + 8 and columns 2t, 2t + 1 (g =
// lane / 4, t = lane % 4).
template <int kNT>
__device__ __forceinline__ void warp_product(float (*c)[4], const float* a, int lda, const float* b,
                                             int ldb, int depth) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k = 0; k < depth; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float b0 = b[(j * 8 + 2 * t) * ldb + k];
      const float b1 = b[(j * 8 + 2 * t + 1) * ldb + k];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

// One warp's share of the [64, kBRows] tile
//   C(t, n) += sum_k A(t0 + t, k) B(n0 + n, k),  k < depth,
// streaming k through shared memory (as: [64][ld_of(kBK)], bs: [kBRows][ld_of(kBK)])
// in kBK-deep chunks. A(t, k) = a[t * lda + k], zero for t >= a_rows, times its
// dropout multiplier when kMaskA. B(n, k) = b[n * ldb + k], or b[k * ldb + n]
// when kTransB; zero for n >= b_rows. The warp's share is rows mrow..mrow+15
// and columns ncol..ncol+8*kNT-1. Starts with a barrier, so the caller's
// earlier reads of as/bs are complete before they are refilled.
template <int kBRows, int kNT, bool kMaskA, bool kTransB>
__device__ __forceinline__ void stream_product(float (*c)[4], float* as, float* bs,
                                               const float* __restrict__ a, int64_t lda, int t0,
                                               int a_rows, const float* __restrict__ b, int64_t ldb,
                                               int n0, int b_rows, int depth, int mrow, int ncol,
                                               const Dropout& drop_a) {
  constexpr int L = ld_of(kBK);
  for (int k0 = 0; k0 < depth; k0 += kBK) {
    __syncthreads();
    load_tile<kBT, kBK, false, kMaskA>(as, L, a, lda, t0, k0, a_rows, depth, drop_a);
    if constexpr (kTransB) {
      load_tile<kBK, kBRows, true, false>(bs, L, b, ldb, k0, n0, depth, b_rows, drop_a);
    } else {
      load_tile<kBRows, kBK, false, false>(bs, L, b, ldb, n0, k0, b_rows, depth, drop_a);
    }
    __syncthreads();
    warp_product<kNT>(c, as + mrow * L, L, bs + ncol * L, L, kBK);
  }
}

template <int kNT>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// ---- forward (K6a), fp32 -----------------------------------------------------------

struct FwdSmem {  // as, bs [64][L_K]; hs [64][L_F]; w2s [kBN][L_F]
  static constexpr int kLK = ld_of(kBK);
  static constexpr int kLF = ld_of(kBF);
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)(kBT + kBF) * kLK + (size_t)(kBT + kBN) * kLF);
};

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int tokens, int d,
                     int f, int d2, Dropout drop1, Dropout drop2) {
  using S = FwdSmem;
  constexpr int kNT1 = kBF / 16;  // n8 tiles of a warp's share of the hidden chunk
  constexpr int kNT2 = kBN / 16;  // n8 tiles of a warp's share of the output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);
  float* bs = as + kBT * S::kLK;
  float* hs = bs + kBF * S::kLK;
  float* w2s = hs + kBT * S::kLF;

  const int t0 = blockIdx.x * kBT;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int mrow = 16 * (warp & 3);
  const int hcol = (warp >> 2) * (kBF / 2);
  const int ocol = (warp >> 2) * (kBN / 2);

  float acc[kNT2][4];
  zero<kNT2>(acc);
  for (int f0 = 0; f0 < f; f0 += kBF) {
    float h[kNT1][4];
    zero<kNT1>(h);
    stream_product<kBF, kNT1, false, false>(h, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                            hcol, drop1);
    // h = drop1(gelu(h + b1)) into hs
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int col = hcol + j * 8 + 2 * t;
      const float bias0 = b1[f0 + col];
      const float bias1 = b1[f0 + col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mrow + g + 8 * r;
        float v0 = gelu(h[j][2 * r] + bias0);
        float v1 = gelu(h[j][2 * r + 1] + bias1);
        if constexpr (kDrop) {
          const float2 m = keep_pair(drop1, t0 + row, f0 + col);
          v0 *= m.x;
          v1 *= m.y;
        }
        *reinterpret_cast<float2*>(hs + row * S::kLF + col) = make_float2(v0, v1);
      }
    }
    load_tile<kBN, kBF, false, false>(w2s, S::kLF, w2, f, n0, f0, d2, f, drop2);
    __syncthreads();
    warp_product<kNT2>(acc, hs + mrow * S::kLF, S::kLF, w2s + ocol * S::kLF, S::kLF, kBF);
  }

#pragma unroll
  for (int j = 0; j < kNT2; ++j) {
    const int gn = n0 + ocol + j * 8 + 2 * t;
    if (gn >= d2) continue;
    const float bias0 = b2[gn];
    const float bias1 = b2[gn + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gt = t0 + mrow + g + 8 * r;
      if (gt >= tokens) continue;
      float v0 = acc[j][2 * r] + bias0;
      float v1 = acc[j][2 * r + 1] + bias1;
      if constexpr (kDrop) {
        const float2 m = keep_pair(drop2, gt, gn);
        v0 *= m.x;
        v1 *= m.y;
      }
      *reinterpret_cast<float2*>(out + (int64_t)gt * d2 + gn) = make_float2(v0, v1);
    }
  }
}

// ---- dx (K6b), fp32 --------------------------------------------------------------

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
fused_mlp_dx_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ dout, float* __restrict__ dx, int tokens, int d,
                    int f, int d2, Dropout drop1, Dropout drop2) {
  using S = FwdSmem;  // the same four buffers: as, bs, dpre tile, W1^T tile
  constexpr int kNT1 = kBF / 16;
  constexpr int kNT2 = kBN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);
  float* bs = as + kBT * S::kLK;
  float* ps = bs + kBF * S::kLK;
  float* w1t = ps + kBT * S::kLF;

  const int t0 = blockIdx.x * kBT;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int mrow = 16 * (warp & 3);
  const int hcol = (warp >> 2) * (kBF / 2);
  const int ocol = (warp >> 2) * (kBN / 2);

  float acc[kNT2][4];
  zero<kNT2>(acc);
  for (int f0 = 0; f0 < f; f0 += kBF) {
    float hp[kNT1][4];  // h_pre, then gelu'(h_pre)
    zero<kNT1>(hp);
    stream_product<kBF, kNT1, false, false>(hp, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                            hcol, drop1);
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int col = f0 + hcol + j * 8 + 2 * t;
      const float bias0 = b1[col];
      const float bias1 = b1[col + 1];
      hp[j][0] = dgelu(hp[j][0] + bias0);
      hp[j][1] = dgelu(hp[j][1] + bias1);
      hp[j][2] = dgelu(hp[j][2] + bias0);
      hp[j][3] = dgelu(hp[j][3] + bias1);
    }
    // dh = do2 W2[:, chunk]: do masked as it is loaded
    float dh[kNT1][4];
    zero<kNT1>(dh);
    stream_product<kBF, kNT1, kDrop, true>(dh, as, bs, dout, d2, t0, tokens, w2, f, f0, f, d2,
                                           mrow, hcol, drop2);
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int col = hcol + j * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mrow + g + 8 * r;
        float v0 = dh[j][2 * r] * hp[j][2 * r];
        float v1 = dh[j][2 * r + 1] * hp[j][2 * r + 1];
        if constexpr (kDrop) {
          const float2 m = keep_pair(drop1, t0 + row, f0 + col);
          v0 *= m.x;
          v1 *= m.y;
        }
        *reinterpret_cast<float2*>(ps + row * S::kLF + col) = make_float2(v0, v1);
      }
    }
    // W1[chunk, cols] as [cols][chunk]
    load_tile<kBF, kBN, true, false>(w1t, S::kLF, w1, d, f0, n0, f, d, drop1);
    __syncthreads();
    warp_product<kNT2>(acc, ps + mrow * S::kLF, S::kLF, w1t + ocol * S::kLF, S::kLF, kBF);
  }

#pragma unroll
  for (int j = 0; j < kNT2; ++j) {
    const int gn = n0 + ocol + j * 8 + 2 * t;
    if (gn >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gt = t0 + mrow + g + 8 * r;
      if (gt < tokens) {
        *reinterpret_cast<float2*>(dx + (int64_t)gt * d + gn) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// ---- dW (K6c), fp32 --------------------------------------------------------------

struct DwSmem {  // as [64][L_K]; bs [128][L_K]; ts1, ts2 [128][L_T]; red [4][128]
  static constexpr int kLK = ld_of(kBK);
  static constexpr int kLT = ld_of(kBT);
  static constexpr size_t kTileBytes =
      sizeof(float) * ((size_t)(kBT + kBW) * kLK + (size_t)2 * kBW * kLT);
  static constexpr size_t kBytes = kTileBytes + sizeof(float) * 4 * kBW;
};

// Blocks [0, blocks_a): dW2 tiles (and db2 where the F tile is the first);
// the rest: dW1 tiles (and db1 where the D tile is the first). dw1 [F, D],
// dw2 [D2, F], db1 [F], db2 [D2].
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
fused_mlp_dw_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ dout, float* __restrict__ dw1,
                    float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ db2,
                    int tokens, int d, int f, int d2, int blocks_a, Dropout drop1,
                    Dropout drop2) {
  using S = DwSmem;
  constexpr int kNT1 = kBW / 16;  // a warp's share of a [64, 128] tile
  constexpr int kNT2 = kBW / 8;   // a warp's share of a [128, 128] tile: 16 rows, all columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);
  float* bs = as + kBT * S::kLK;
  float* ts1 = bs + kBW * S::kLK;
  float* ts2 = ts1 + kBW * S::kLT;
  float* red = reinterpret_cast<float*>(smem_raw + S::kTileBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mrow = 16 * (warp & 3);
  const int hcol = (warp >> 2) * (kBW / 2);
  const int prow = 16 * warp;

  float acc[kNT2][4];
  zero<kNT2>(acc);

  if ((int)blockIdx.x < blocks_a) {
    // dW2[n0.., f0..] += do2^T h over all tokens
    const int n0 = (blockIdx.x / (f / kBW)) * kBW;
    const int f0 = (blockIdx.x % (f / kBW)) * kBW;
    const bool with_db2 = f0 == 0;
    const int col = threadIdx.x & (kBW - 1);  // db2: this thread's column and half of the rows
    const int half = threadIdx.x / kBW;
    float db2_part = 0.f;
    for (int t0 = 0; t0 < tokens; t0 += kBT) {
      float h[kNT1][4];
      zero<kNT1>(h);
      stream_product<kBW, kNT1, false, false>(h, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                              hcol, drop1);
#pragma unroll
      for (int j = 0; j < kNT1; ++j) {
        const int c = hcol + j * 8 + 2 * t;
        const float bias0 = b1[f0 + c];
        const float bias1 = b1[f0 + c + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = mrow + g + 8 * r;
          float v0 = gelu(h[j][2 * r] + bias0);
          float v1 = gelu(h[j][2 * r + 1] + bias1);
          if constexpr (kDrop) {
            const float2 m = keep_pair(drop1, t0 + row, f0 + c);
            v0 *= m.x;
            v1 *= m.y;
          }
          ts1[c * S::kLT + row] = v0;  // h^T [f][t]
          ts1[(c + 1) * S::kLT + row] = v1;
        }
      }
      load_tile<kBT, kBW, true, kDrop>(ts2, S::kLT, dout, d2, t0, n0, tokens, d2, drop2);
      if (with_db2) {
        for (int r = half * (kBT / 2); r < (half + 1) * (kBT / 2) && t0 + r < tokens; ++r) {
          float v = dout[(int64_t)(t0 + r) * d2 + n0 + col];
          if constexpr (kDrop) v *= keep_one(drop2, t0 + r, n0 + col);
          db2_part += v;
        }
      }
      __syncthreads();
      warp_product<kNT2>(acc, ts2 + prow * S::kLT, S::kLT, ts1, S::kLT, kBT);
    }
#pragma unroll
    for (int j = 0; j < kNT2; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = n0 + prow + g + 8 * r;
        *reinterpret_cast<float2*>(dw2 + (int64_t)row * f + f0 + j * 8 + 2 * t) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
    if (with_db2) {
      red[half * kBW + col] = db2_part;
      __syncthreads();
      if (threadIdx.x < kBW) db2[n0 + threadIdx.x] = red[threadIdx.x] + red[kBW + threadIdx.x];
    }
    return;
  }

  // dW1[f0.., d0..] += dpre^T x over all tokens
  const int idx = blockIdx.x - blocks_a;
  const int f0 = (idx / (d / kBW)) * kBW;
  const int d0 = (idx % (d / kBW)) * kBW;
  const bool with_db1 = d0 == 0;
  float db1_part[kNT1][2];
#pragma unroll
  for (int j = 0; j < kNT1; ++j) db1_part[j][0] = db1_part[j][1] = 0.f;
  for (int t0 = 0; t0 < tokens; t0 += kBT) {
    float hp[kNT1][4];  // h_pre, then gelu'(h_pre)
    zero<kNT1>(hp);
    stream_product<kBW, kNT1, false, false>(hp, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                            hcol, drop1);
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int c = f0 + hcol + j * 8 + 2 * t;
      const float bias0 = b1[c];
      const float bias1 = b1[c + 1];
      hp[j][0] = dgelu(hp[j][0] + bias0);
      hp[j][1] = dgelu(hp[j][1] + bias1);
      hp[j][2] = dgelu(hp[j][2] + bias0);
      hp[j][3] = dgelu(hp[j][3] + bias1);
    }
    float dh[kNT1][4];
    zero<kNT1>(dh);
    stream_product<kBW, kNT1, kDrop, true>(dh, as, bs, dout, d2, t0, tokens, w2, f, f0, f, d2,
                                           mrow, hcol, drop2);
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int c = hcol + j * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mrow + g + 8 * r;
        float v0 = dh[j][2 * r] * hp[j][2 * r];
        float v1 = dh[j][2 * r + 1] * hp[j][2 * r + 1];
        if constexpr (kDrop) {
          const float2 m = keep_pair(drop1, t0 + row, f0 + c);
          v0 *= m.x;
          v1 *= m.y;
        }
        db1_part[j][0] += v0;  // rows past T have do = 0, so dpre = 0
        db1_part[j][1] += v1;
        ts1[c * S::kLT + row] = v0;  // dpre^T [f][t]
        ts1[(c + 1) * S::kLT + row] = v1;
      }
    }
    load_tile<kBT, kBW, true, false>(ts2, S::kLT, x, d, t0, d0, tokens, d, drop1);  // x^T [d][t]
    __syncthreads();
    warp_product<kNT2>(acc, ts1 + prow * S::kLT, S::kLT, ts2, S::kLT, kBT);
  }
#pragma unroll
  for (int j = 0; j < kNT2; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = f0 + prow + g + 8 * r;
      *reinterpret_cast<float2*>(dw1 + (int64_t)row * d + d0 + j * 8 + 2 * t) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
  if (with_db1) {
    // sum over the 8 row groups of the warp (fixed xor tree), then over the
    // four warps that share these columns, in order
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = db1_part[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[(warp & 3) * kBW + hcol + j * 8 + 2 * t + e] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < kBW) {
      db1[f0 + threadIdx.x] = ((red[threadIdx.x] + red[kBW + threadIdx.x]) +
                               red[2 * kBW + threadIdx.x]) + red[3 * kBW + threadIdx.x];
    }
  }
}

// ---- launch -----------------------------------------------------------------------

struct Args {
  const void* x;
  const void* w1;
  const void* b1;
  const void* w2;
  int tokens, d, f, d2;
  Dropout drop1, drop2;
  cudaStream_t stream;
};

template <bool kDrop>
int launch_fwd(const Args& a, const void* b2, void* out) {
  const size_t smem = FwdSmem::kBytes;
  cudaError_t err = orbit2::allow_smem(fused_mlp_fwd_kernel<kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tokens + kBT - 1) / kBT, (a.d2 + kBN - 1) / kBN);
  fused_mlp_fwd_kernel<kDrop><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
      static_cast<const float*>(b2), static_cast<float*>(out), a.tokens, a.d, a.f, a.d2, a.drop1,
      a.drop2);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_dx(const Args& a, const void* dout, void* dx) {
  const size_t smem = FwdSmem::kBytes;
  cudaError_t err = orbit2::allow_smem(fused_mlp_dx_kernel<kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tokens + kBT - 1) / kBT, (a.d + kBN - 1) / kBN);
  fused_mlp_dx_kernel<kDrop><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
      static_cast<const float*>(dout), static_cast<float*>(dx), a.tokens, a.d, a.f, a.d2, a.drop1,
      a.drop2);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_dw(const Args& a, const void* dout, float* dw1, float* db1, float* dw2, float* db2) {
  const size_t smem = DwSmem::kBytes;
  cudaError_t err = orbit2::allow_smem(fused_mlp_dw_kernel<kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks_a = (a.d2 / kBW) * (a.f / kBW);
  const int blocks_b = (a.f / kBW) * (a.d / kBW);
  fused_mlp_dw_kernel<kDrop><<<blocks_a + blocks_b, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
      static_cast<const float*>(dout), dw1, db1, dw2, db2, a.tokens, a.d, a.f, a.d2, blocks_a,
      a.drop1, a.drop2);
  return (int)cudaGetLastError();
}

// Validates the shape contract; fills `a`. 0 when the call can go ahead.
int make_args(Args* a, int dtype, const void* x, const void* w1, const void* b1, const void* w2,
              int64_t tokens, int64_t d, int64_t f, int64_t d2, int dropout, uint64_t seed1,
              uint64_t seed2, uint32_t threshold, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (tokens < 8 || tokens % 8 || d % kBW || f % kBW || d2 % kBW || d <= 0 || f <= 0 || d2 <= 0 ||
      tokens > (1LL << 30) || d > (1 << 20) || f > (1 << 20) || d2 > (1 << 20)) {
    return -1;
  }
  *a = Args{x, w1, b1, w2, (int)tokens, (int)d, (int)f, (int)d2,
            Dropout{dropout ? seed1 : 0u, threshold, scale},
            Dropout{dropout ? seed2 : 0u, threshold, scale}, static_cast<cudaStream_t>(stream)};
  return 0;
}

// The bf16 backward's operands for fused_mlp_hopper.cuh.
orbit2::mlp::BwdOperands bwd_operands(const Args& a, const void* dout, const void* dout2,
                                      void* dpre, void* h, void* db1_part, void* db2_part) {
  return orbit2::mlp::BwdOperands{
      static_cast<const bf16*>(a.x),  static_cast<const bf16*>(a.w1),
      static_cast<const bf16*>(a.b1), static_cast<const bf16*>(a.w2),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(dout2),
      static_cast<bf16*>(dpre),       static_cast<bf16*>(h),
      static_cast<float*>(db1_part),  static_cast<float*>(db2_part),
      a.tokens, a.d, a.f, a.d2, a.drop1, a.drop2};
}

// Stage H of the bf16 backward (fused_mlp_hopper.cuh) into the workspace.
int launch_hidden(const orbit2::mlp::BwdOperands& o, int dropout, cudaStream_t stream) {
  return dropout ? orbit2::mlp::launch_hidden<true>(o, stream)
                 : orbit2::mlp::launch_hidden<false>(o, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16
// (all tensors of that dtype, contiguous, 16-byte aligned). x [tokens, d],
// w1 [f, d], b1 [f], w2 [d2, f], b2 [d2], dout [tokens, d2]. dropout != 0
// applies the two masks (seed1 hidden, seed2 output; kept when the bits are
// <= threshold, then scaled by `scale`). Return 0 on success, a cudaError_t
// code if the launch failed, -1 for a dtype or shape the kernels do not
// take (tokens a multiple of 8, d/f/d2 multiples of 128) or a missing bf16
// workspace, or -2 (kEncodeFailed) when the driver refuses a bf16 kernel's
// tensor map.
//
// The bf16 entries take a bf16 workspace (fused_mlp_hopper.cuh); the
// backward entries also take dout2, do2 = bf16(dout m2) (dout itself at
// rate 0), for the bf16 products. The fp32 kernels need no workspace and
// mask dout themselves.

// out [tokens, d2] in the input dtype. bf16: F1 writes h_r into h [tokens,
// f], then F2 writes out; fp32: h is not used.
extern "C" int orbit2_fused_mlp_fwd(int dtype, const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, void* h,
                                    int64_t tokens, int64_t d, int64_t f, int64_t d2, int dropout,
                                    uint64_t seed1, uint64_t seed2, uint32_t threshold,
                                    float scale, void* stream) {
  Args a;
  if (make_args(&a, dtype, x, w1, b1, w2, tokens, d, f, d2, dropout, seed1, seed2, threshold,
                scale, stream)) {
    return -1;
  }
  if (dtype == 1) {
    if (h == nullptr) return -1;
    const orbit2::mlp::FwdOperands o{
        static_cast<const bf16*>(x),  static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(h),
        static_cast<bf16*>(out),      a.tokens, a.d, a.f, a.d2, a.drop1, a.drop2};
    return orbit2::mlp::launch_fwd(o, dropout != 0, a.stream);
  }
  return dropout ? launch_fwd<true>(a, b2, out) : launch_fwd<false>(a, b2, out);
}

// dx [tokens, d] in the input dtype. bf16: stage H into dpre [tokens, f]
// unless have_dpre (dpre already holds stage H's dpre_r), then dx = dpre_r W1.
extern "C" int orbit2_fused_mlp_dx(int dtype, const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dout, const void* dout2, void* dx,
                                   void* dpre, int have_dpre, int64_t tokens, int64_t d,
                                   int64_t f, int64_t d2, int dropout, uint64_t seed1,
                                   uint64_t seed2, uint32_t threshold, float scale, void* stream) {
  Args a;
  if (make_args(&a, dtype, x, w1, b1, w2, tokens, d, f, d2, dropout, seed1, seed2, threshold,
                scale, stream)) {
    return -1;
  }
  if (dtype == 1) {
    const orbit2::mlp::BwdOperands o =
        bwd_operands(a, dout, dout2, dpre, nullptr, nullptr, nullptr);
    if (!have_dpre) {
      const int err = launch_hidden(o, dropout, a.stream);
      if (err) return err;
    }
    return orbit2::mlp::launch_dx(o, static_cast<bf16*>(dx), a.stream);
  }
  return dropout ? launch_dx<true>(a, dout, dx) : launch_dx<false>(a, dout, dx);
}

// dw1 [f, d], db1 [f], dw2 [d2, f], db2 [d2], all fp32. bf16: the workspace
// dpre, h [tokens, f] bf16, db1_part [ceil(tokens / 128), f] and db2_part
// [ceil(tokens / 64), d2] fp32; stage H, db2's partials, then the dW
// products, which sum both biases' partials; dpre then holds dpre_r for
// orbit2_fused_mlp_dx.
extern "C" int orbit2_fused_mlp_dw(int dtype, const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dout, const void* dout2, void* dw1,
                                   void* db1, void* dw2, void* db2, void* dpre, void* h,
                                   void* db1_part, void* db2_part, int64_t tokens, int64_t d,
                                   int64_t f, int64_t d2, int dropout, uint64_t seed1,
                                   uint64_t seed2, uint32_t threshold, float scale, void* stream) {
  Args a;
  if (make_args(&a, dtype, x, w1, b1, w2, tokens, d, f, d2, dropout, seed1, seed2, threshold,
                scale, stream)) {
    return -1;
  }
  float* o[4] = {static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(dw2),
                 static_cast<float*>(db2)};
  if (dtype == 1) {
    const orbit2::mlp::BwdOperands ops = bwd_operands(a, dout, dout2, dpre, h, db1_part, db2_part);
    int err = launch_hidden(ops, dropout, a.stream);
    if (!err) {
      err = dropout ? orbit2::mlp::launch_bias2<true>(ops, a.stream)
                    : orbit2::mlp::launch_bias2<false>(ops, a.stream);
    }
    return err ? err : orbit2::mlp::launch_dw(ops, o[0], o[1], o[2], o[3], a.stream);
  }
  return dropout ? launch_dw<true>(a, dout, o[0], o[1], o[2], o[3])
                 : launch_dw<false>(a, dout, o[0], o[1], o[2], o[3]);
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

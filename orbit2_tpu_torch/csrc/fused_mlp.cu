// Fused transformer MLP for Hopper (sm_90a): out = drop2(drop1(gelu(x W1^T + b1)) W2^T + b2)
// and its backward, without ever storing the [T, F] hidden activation.
//
// Replaces the Pallas TPU kernels of orbit2_tpu/ops/fused_mlp.py:
//   * `_fwd_kernel` (:125, called at :154)  -> fused_mlp_fwd_kernel
//   * `_dx_kernel`  (:177, called at :363)  -> fused_mlp_dx_kernel
//   * `_dw_kernel`  (:209, called at :386)  -> fused_mlp_dw_kernel
//
// Layout: x [T, D] and the output gradient do [T, D2] row-major; the weights
// as PyTorch's Linear stores them, W1 [F, D] and W2 [D2, F], read as stored
// (no transposed copy per call); b1 [F], b2 [D2]. One dtype for all of them:
// bf16 (products on mma.sync m16n8k16 tensor cores) or fp32 (products on FMAs
// in the same accumulator layout, so every epilogue is shared). T is any
// multiple of 8 (ragged T tiles are zero-filled and masked); D, F and D2 are
// multiples of 128.
//
// Rounding points are the TPU kernels': fp32 accumulation; the hidden h
// rounded to the input dtype before the second product (:139); + b2 and the
// output mask in fp32, then one rounding (:144-147). Backward: do2 = do * m2
// rounded to the dtype (:184-187); dh = do2 W2 (fp32) times m1; dpre = dh *
// gelu'(h_pre) with h_pre recomputed; dx = dpre_r W1; dW2 = do2^T h_r; dW1 =
// dpre_r^T x (r = rounded to the dtype); db1 = sum_t dpre and db2 = sum_t
// do * m2 in fp32, unrounded. GELU and its derivative are evaluated in fp32
// with CUDA's erff (the TPU's Abramowitz-Stegun erf, :57-65, is not carried).
//
// Dropout (the kDrop instances; rate 0 compiles to kernels without it): the
// multiplier of hidden element (t, f) is that of csrc/kernel_prng.cuh at
// (seed1, stream 0, row t, col f) and of output element (t, n) at (seed2, 0,
// t, n), one Philox call per 8 columns: exactly the bits the fused dropout
// (fused_dropout.cu) draws for the unfused Mlp's two dropouts under the same
// seeds, and independent of tiles (the TPU's 256-unit mask grid, :81-119, has
// no counterpart).
//
// What bounds it on the H100, and the design. The TPU kernels keep an fp32
// [512, D2] accumulator in 16 MB of VMEM; an H100 block has at most 227 KB of
// shared memory and 255 registers a thread. So every block owns one output
// tile and recomputes what it needs:
//   * forward: a (64 tokens, 256 output columns) tile; for each 64-wide
//     hidden chunk it computes h = x W1[chunk]^T (streaming D through shared
//     memory in 64-deep chunks), applies b1, GELU and m1, rounds h into shared
//     memory and adds h W2[cols, chunk]^T to registers. x W1^T is recomputed
//     D2/256 times.
//   * dx: a (64 tokens, 256 columns of D) tile; per hidden chunk it recomputes
//     h_pre (depth D) and dh = do2 W2 (depth D2, do masked and rounded as it is
//     loaded), forms dpre in registers and adds dpre W1[chunk, cols].
//   * dW: two kinds of block in one grid. A (128 rows of D2, 128 of F) block
//     of dW2 recomputes h for each 64-token chunk and adds do2^T h; a (128 of
//     F, 128 of D) block of dW1 recomputes h_pre and dh and adds dpre^T x.
//     The F-column-0 blocks of the first kind also sum db2 and the D-column-0
//     blocks of the second kind db1.
// Every sum over T runs in a fixed order inside one block (no atomics), so
// two runs give bit-equal gradients. The recomputation makes this first
// kernel do several times the products of cuBLAS's plain chain; a design that
// shares h across output tiles (wgmma, TMA-fed pipelines) is later work.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using orbit2::bf16;
using orbit2::Dropout;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBT = 64;        // tokens per tile
constexpr int kBK = 64;        // depth of one streamed chunk
constexpr int kBF = 64;        // hidden chunk of the forward and dx blocks
constexpr int kBN = 256;       // output columns of a forward or dx block
constexpr int kBW = 128;       // edge of a dW tile

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Row stride of a shared tile of `cols` elements: 16 bytes of padding keeps
// the fragment reads free of bank conflicts and rows 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int ld_of(int cols) {
  return cols + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Stores two adjacent elements (p 2-element aligned).
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<uint32_t*>(p) = orbit2::pack_bf16x2(lo, hi);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
}

__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * kInvSqrt2)); }

__device__ __forceinline__ float dgelu(float v) {
  return 0.5f * (1.f + erff(v * kInvSqrt2)) + v * expf(-0.5f * v * v) * kInvSqrt2Pi;
}

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
// each element is multiplied in fp32 by its multiplier at global (row, col)
// and rounded once to T.
template <typename T, int kRows, int kCols, bool kTrans, bool kMask>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int64_t src_ld,
                                          int row0, int col0, int n_rows, int n_cols,
                                          const Dropout& drop) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = kCols / kVec;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    // transposed: consecutive threads take consecutive rows, so their stores
    // land in consecutive banks (one row per thread would put a warp's
    // stores, kVec * ld elements apart, into one bank)
    const int r = kTrans ? idx % kRows : idx / kChunks;
    const int c = (kTrans ? idx / kRows : idx % kChunks) * kVec;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    T* v = reinterpret_cast<T*>(&chunk);
    if (row0 + r < n_rows && col0 + c < n_cols) {
      chunk = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * src_ld + col0 + c);
      if constexpr (kMask) {
        // one call covers the chunk's kVec columns (8 bf16, or half a call's 8 fp32)
        const uint32_t dropped = drop_flags_at(drop, row0 + r, col0 + c) >> ((col0 + c) & 7);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[e] = from_f32<T>(to_f32(v[e]) * (((dropped >> e) & 1u) ? 0.f : drop.scale));
        }
      }
    }
    if constexpr (kTrans) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[(c + i) * ld + r] = v[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = chunk;
    }
  }
}

// c[j] += A B_j^T over `depth` for one warp: A is the warp's 16 rows ([16][depth]
// at a, row stride lda), B_j rows 8j..8j+7 of b ([kNT * 8][depth], stride ldb).
// c[j] holds the m16n8 accumulator layout of flash_common.cuh's mma_16816:
// rows g, g + 8 and columns 2t, 2t + 1 (g = lane / 4, t = lane % 4). bf16 runs
// on the tensor cores; fp32 does the same sums with FMAs in the same layout.
template <typename T, int kNT>
__device__ __forceinline__ void warp_product(float (*c)[4], const T* a, int lda, const T* b, int ldb,
                                             int depth) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int kk = 0; kk < depth; kk += 16) {
      const bf16* pa = a + g * lda + kk + 2 * t;
      const uint32_t af[4] = {orbit2::ld32(pa), orbit2::ld32(pa + 8 * lda), orbit2::ld32(pa + 8),
                              orbit2::ld32(pa + 8 * lda + 8)};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* pb = b + (j * 8 + g) * ldb + kk + 2 * t;
        const uint32_t bf[2] = {orbit2::ld32(pb), orbit2::ld32(pb + 8)};
        orbit2::mma_16816(c[j], af, bf);
      }
    }
  } else {
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
}

// One warp's share of the [64, kBRows] tile
//   C(t, n) += sum_k A(t0 + t, k) B(n0 + n, k),  k < depth,
// streaming k through shared memory (as: [64][ld_of(kBK)], bs: [kBRows][ld_of(kBK)])
// in kBK-deep chunks. A(t, k) = a[t * lda + k], zero for t >= a_rows, times its
// dropout multiplier (rounded to T) when kMaskA. B(n, k) = b[n * ldb + k], or
// b[k * ldb + n] when kTransB; zero for n >= b_rows. The warp's share is rows
// mrow..mrow+15 and columns ncol..ncol+8*kNT-1. Starts with a barrier, so the
// caller's earlier reads of as/bs are complete before they are refilled.
template <typename T, int kBRows, int kNT, bool kMaskA, bool kTransB>
__device__ __forceinline__ void stream_product(float (*c)[4], T* as, T* bs, const T* __restrict__ a,
                                               int64_t lda, int t0, int a_rows,
                                               const T* __restrict__ b, int64_t ldb, int n0,
                                               int b_rows, int depth, int mrow, int ncol,
                                               const Dropout& drop_a) {
  constexpr int L = ld_of<T>(kBK);
  for (int k0 = 0; k0 < depth; k0 += kBK) {
    __syncthreads();
    load_tile<T, kBT, kBK, false, kMaskA>(as, L, a, lda, t0, k0, a_rows, depth, drop_a);
    if constexpr (kTransB) {
      load_tile<T, kBK, kBRows, true, false>(bs, L, b, ldb, k0, n0, depth, b_rows, drop_a);
    } else {
      load_tile<T, kBRows, kBK, false, false>(bs, L, b, ldb, n0, k0, b_rows, depth, drop_a);
    }
    __syncthreads();
    warp_product<T, kNT>(c, as + mrow * L, L, bs + ncol * L, L, kBK);
  }
}

template <int kNT>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// ---- forward (K6a) ------------------------------------------------------------

template <typename T>
struct FwdSmem {  // as, bs [64][L_K]; hs [64][L_F]; w2s [kBN][L_F]
  static constexpr int kLK = ld_of<T>(kBK);
  static constexpr int kLF = ld_of<T>(kBF);
  static constexpr size_t kBytes = sizeof(T) * ((size_t)(kBT + kBF) * kLK + (size_t)(kBT + kBN) * kLF);
};

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                     int tokens, int d, int f, int d2, Dropout drop1, Dropout drop2) {
  using S = FwdSmem<T>;
  constexpr int kNT1 = kBF / 16;  // n8 tiles of a warp's share of the hidden chunk
  constexpr int kNT2 = kBN / 16;  // n8 tiles of a warp's share of the output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + kBT * S::kLK;
  T* hs = bs + kBF * S::kLK;
  T* w2s = hs + kBT * S::kLF;

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
    stream_product<T, kBF, kNT1, false, false>(h, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                               hcol, drop1);
    // h = drop1(gelu(h + b1)), rounded to T, into hs
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int col = hcol + j * 8 + 2 * t;
      const float bias0 = to_f32(b1[f0 + col]);
      const float bias1 = to_f32(b1[f0 + col + 1]);
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
        store2<T>(hs + row * S::kLF + col, v0, v1);
      }
    }
    load_tile<T, kBN, kBF, false, false>(w2s, S::kLF, w2, f, n0, f0, d2, f, drop2);
    __syncthreads();
    warp_product<T, kNT2>(acc, hs + mrow * S::kLF, S::kLF, w2s + ocol * S::kLF, S::kLF, kBF);
  }

#pragma unroll
  for (int j = 0; j < kNT2; ++j) {
    const int gn = n0 + ocol + j * 8 + 2 * t;
    if (gn >= d2) continue;
    const float bias0 = to_f32(b2[gn]);
    const float bias1 = to_f32(b2[gn + 1]);
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
      store2<T>(out + (int64_t)gt * d2 + gn, v0, v1);
    }
  }
}

// ---- dx (K6b) -------------------------------------------------------------------

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fused_mlp_dx_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const T* __restrict__ dout, T* __restrict__ dx,
                    int tokens, int d, int f, int d2, Dropout drop1, Dropout drop2) {
  using S = FwdSmem<T>;  // the same four buffers: as, bs, dpre tile, W1^T tile
  constexpr int kNT1 = kBF / 16;
  constexpr int kNT2 = kBN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + kBT * S::kLK;
  T* ps = bs + kBF * S::kLK;
  T* w1t = ps + kBT * S::kLF;

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
    stream_product<T, kBF, kNT1, false, false>(hp, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                               hcol, drop1);
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int col = f0 + hcol + j * 8 + 2 * t;
      const float bias0 = to_f32(b1[col]);
      const float bias1 = to_f32(b1[col + 1]);
      hp[j][0] = dgelu(hp[j][0] + bias0);
      hp[j][1] = dgelu(hp[j][1] + bias1);
      hp[j][2] = dgelu(hp[j][2] + bias0);
      hp[j][3] = dgelu(hp[j][3] + bias1);
    }
    // dh = do2 W2[:, chunk]: do masked and rounded as it is loaded
    float dh[kNT1][4];
    zero<kNT1>(dh);
    stream_product<T, kBF, kNT1, kDrop, true>(dh, as, bs, dout, d2, t0, tokens, w2, f, f0, f, d2,
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
        store2<T>(ps + row * S::kLF + col, v0, v1);
      }
    }
    // W1[chunk, cols] as [cols][chunk]
    load_tile<T, kBF, kBN, true, false>(w1t, S::kLF, w1, d, f0, n0, f, d, drop1);
    __syncthreads();
    warp_product<T, kNT2>(acc, ps + mrow * S::kLF, S::kLF, w1t + ocol * S::kLF, S::kLF, kBF);
  }

#pragma unroll
  for (int j = 0; j < kNT2; ++j) {
    const int gn = n0 + ocol + j * 8 + 2 * t;
    if (gn >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gt = t0 + mrow + g + 8 * r;
      if (gt < tokens) store2<T>(dx + (int64_t)gt * d + gn, acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// ---- dW (K6c) -------------------------------------------------------------------

template <typename T>
struct DwSmem {  // as [64][L_K]; bs [128][L_K]; ts1, ts2 [128][L_T]; red fp32 [4][128]
  static constexpr int kLK = ld_of<T>(kBK);
  static constexpr int kLT = ld_of<T>(kBT);
  static constexpr size_t kTileBytes =
      sizeof(T) * ((size_t)(kBT + kBW) * kLK + (size_t)2 * kBW * kLT);
  static constexpr size_t kBytes = kTileBytes + sizeof(float) * 4 * kBW;
};

// Blocks [0, blocks_a): dW2 tiles (and db2 where the F tile is the first);
// the rest: dW1 tiles (and db1 where the D tile is the first). dw1 [F, D],
// dw2 [D2, F], db1 [F], db2 [D2], all fp32.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
fused_mlp_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const T* __restrict__ dout, float* __restrict__ dw1,
                    float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ db2,
                    int tokens, int d, int f, int d2, int blocks_a, Dropout drop1,
                    Dropout drop2) {
  using S = DwSmem<T>;
  constexpr int kNT1 = kBW / 16;  // a warp's share of a [64, 128] tile
  constexpr int kNT2 = kBW / 8;   // a warp's share of a [128, 128] tile: 16 rows, all columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + kBT * S::kLK;
  T* ts1 = bs + kBW * S::kLK;
  T* ts2 = ts1 + kBW * S::kLT;
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
      stream_product<T, kBW, kNT1, false, false>(h, as, bs, x, d, t0, tokens, w1, d, f0, f, d,
                                                 mrow, hcol, drop1);
#pragma unroll
      for (int j = 0; j < kNT1; ++j) {
        const int c = hcol + j * 8 + 2 * t;
        const float bias0 = to_f32(b1[f0 + c]);
        const float bias1 = to_f32(b1[f0 + c + 1]);
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
          ts1[c * S::kLT + row] = from_f32<T>(v0);  // h^T [f][t]
          ts1[(c + 1) * S::kLT + row] = from_f32<T>(v1);
        }
      }
      load_tile<T, kBT, kBW, true, kDrop>(ts2, S::kLT, dout, d2, t0, n0, tokens, d2, drop2);
      if (with_db2) {
        for (int r = half * (kBT / 2); r < (half + 1) * (kBT / 2) && t0 + r < tokens; ++r) {
          float v = to_f32(dout[(int64_t)(t0 + r) * d2 + n0 + col]);
          if constexpr (kDrop) v *= keep_one(drop2, t0 + r, n0 + col);
          db2_part += v;
        }
      }
      __syncthreads();
      warp_product<T, kNT2>(acc, ts2 + prow * S::kLT, S::kLT, ts1, S::kLT, kBT);
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
    stream_product<T, kBW, kNT1, false, false>(hp, as, bs, x, d, t0, tokens, w1, d, f0, f, d, mrow,
                                               hcol, drop1);
#pragma unroll
    for (int j = 0; j < kNT1; ++j) {
      const int c = f0 + hcol + j * 8 + 2 * t;
      const float bias0 = to_f32(b1[c]);
      const float bias1 = to_f32(b1[c + 1]);
      hp[j][0] = dgelu(hp[j][0] + bias0);
      hp[j][1] = dgelu(hp[j][1] + bias1);
      hp[j][2] = dgelu(hp[j][2] + bias0);
      hp[j][3] = dgelu(hp[j][3] + bias1);
    }
    float dh[kNT1][4];
    zero<kNT1>(dh);
    stream_product<T, kBW, kNT1, kDrop, true>(dh, as, bs, dout, d2, t0, tokens, w2, f, f0, f, d2,
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
        ts1[c * S::kLT + row] = from_f32<T>(v0);  // dpre^T [f][t]
        ts1[(c + 1) * S::kLT + row] = from_f32<T>(v1);
      }
    }
    load_tile<T, kBT, kBW, true, false>(ts2, S::kLT, x, d, t0, d0, tokens, d, drop1);  // x^T [d][t]
    __syncthreads();
    warp_product<T, kNT2>(acc, ts1 + prow * S::kLT, S::kLT, ts2, S::kLT, kBT);
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

template <typename T, bool kDrop>
int launch_fwd(const Args& a, const void* b2, void* out) {
  const size_t smem = FwdSmem<T>::kBytes;
  cudaError_t err = orbit2::allow_smem(fused_mlp_fwd_kernel<T, kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tokens + kBT - 1) / kBT, (a.d2 + kBN - 1) / kBN);
  fused_mlp_fwd_kernel<T, kDrop><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
      static_cast<const T*>(a.w2), static_cast<const T*>(b2), static_cast<T*>(out), a.tokens, a.d,
      a.f, a.d2, a.drop1, a.drop2);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_dx(const Args& a, const void* dout, void* dx) {
  const size_t smem = FwdSmem<T>::kBytes;
  cudaError_t err = orbit2::allow_smem(fused_mlp_dx_kernel<T, kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tokens + kBT - 1) / kBT, (a.d + kBN - 1) / kBN);
  fused_mlp_dx_kernel<T, kDrop><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
      static_cast<const T*>(a.w2), static_cast<const T*>(dout), static_cast<T*>(dx), a.tokens,
      a.d, a.f, a.d2, a.drop1, a.drop2);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_dw(const Args& a, const void* dout, float* dw1, float* db1, float* dw2, float* db2) {
  const size_t smem = DwSmem<T>::kBytes;
  cudaError_t err = orbit2::allow_smem(fused_mlp_dw_kernel<T, kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks_a = (a.d2 / kBW) * (a.f / kBW);
  const int blocks_b = (a.f / kBW) * (a.d / kBW);
  fused_mlp_dw_kernel<T, kDrop><<<blocks_a + blocks_b, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
      static_cast<const T*>(a.w2), static_cast<const T*>(dout), dw1, db1, dw2, db2, a.tokens, a.d,
      a.f, a.d2, blocks_a, a.drop1, a.drop2);
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

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16
// (all tensors of that dtype, contiguous, 16-byte aligned). x [tokens, d],
// w1 [f, d], b1 [f], w2 [d2, f], b2 [d2], dout [tokens, d2]. dropout != 0
// applies the two masks (seed1 hidden, seed2 output; kept when the bits are
// <= threshold, then scaled by `scale`). Return 0 on success, a cudaError_t
// code if the launch failed, or -1 for a dtype or shape the kernels do not
// take (tokens a multiple of 8, d/f/d2 multiples of 128).

extern "C" int orbit2_fused_mlp_fwd(int dtype, const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, int64_t tokens,
                                    int64_t d, int64_t f, int64_t d2, int dropout, uint64_t seed1,
                                    uint64_t seed2, uint32_t threshold, float scale,
                                    void* stream) {
  Args a;
  if (make_args(&a, dtype, x, w1, b1, w2, tokens, d, f, d2, dropout, seed1, seed2, threshold,
                scale, stream)) {
    return -1;
  }
  if (dtype == 1) {
    return dropout ? launch_fwd<bf16, true>(a, b2, out) : launch_fwd<bf16, false>(a, b2, out);
  }
  return dropout ? launch_fwd<float, true>(a, b2, out) : launch_fwd<float, false>(a, b2, out);
}

// dx [tokens, d] in the input dtype.
extern "C" int orbit2_fused_mlp_dx(int dtype, const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dout, void* dx, int64_t tokens,
                                   int64_t d, int64_t f, int64_t d2, int dropout, uint64_t seed1,
                                   uint64_t seed2, uint32_t threshold, float scale, void* stream) {
  Args a;
  if (make_args(&a, dtype, x, w1, b1, w2, tokens, d, f, d2, dropout, seed1, seed2, threshold,
                scale, stream)) {
    return -1;
  }
  if (dtype == 1) {
    return dropout ? launch_dx<bf16, true>(a, dout, dx) : launch_dx<bf16, false>(a, dout, dx);
  }
  return dropout ? launch_dx<float, true>(a, dout, dx) : launch_dx<float, false>(a, dout, dx);
}

// dw1 [f, d], db1 [f], dw2 [d2, f], db2 [d2], all fp32.
extern "C" int orbit2_fused_mlp_dw(int dtype, const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dout, void* dw1, void* db1,
                                   void* dw2, void* db2, int64_t tokens, int64_t d, int64_t f,
                                   int64_t d2, int dropout, uint64_t seed1, uint64_t seed2,
                                   uint32_t threshold, float scale, void* stream) {
  Args a;
  if (make_args(&a, dtype, x, w1, b1, w2, tokens, d, f, d2, dropout, seed1, seed2, threshold,
                scale, stream)) {
    return -1;
  }
  float* o[4] = {static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(dw2),
                 static_cast<float*>(db2)};
  if (dtype == 1) {
    return dropout ? launch_dw<bf16, true>(a, dout, o[0], o[1], o[2], o[3])
                   : launch_dw<bf16, false>(a, dout, o[0], o[1], o[2], o[3]);
  }
  return dropout ? launch_dw<float, true>(a, dout, o[0], o[1], o[2], o[3])
                 : launch_dw<float, false>(a, dout, o[0], o[1], o[2], o[3]);
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

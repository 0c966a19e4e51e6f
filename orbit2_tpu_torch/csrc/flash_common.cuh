// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, the Hopper kernels of flash_fwd_hopper.cuh and
// flash_bwd_hopper.cuh) and the fused MLP: the bf16 mma.sync product, the
// fragment and tile loads and the score tile product (the backward at
// D = 256), the dropout keep tile (the fp32 kernels and the backward at
// D = 256) and the launch arguments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_prng.cuh"

namespace orbit2 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values from consecutive rows of a row-major tile: the B fragment
// of a product whose k index runs down the tile's rows.
__device__ __forceinline__ uint32_t ld_pair_rows(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b for one 16x8 tile: a 16x16 (row), b 16x8 (col), bf16 in, fp32 acc.
// Fragments (g = lane / 4, t = lane % 4): a = {(g, 2t..), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t.., n g), (k 2t+8.., n g)};
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies rows [row0, row0 + kRows) of one head (D bf16 each, every row
// 16-byte aligned) into a row-major shared tile, 8 elements per step,
// zero-filling rows at or past n_valid.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_bf16_rows(bf16* dst, int ld, const bf16* base,
                                               int64_t row_stride, int row0, int n_valid) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      chunk = *reinterpret_cast<const uint4*>(base + (int64_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = chunk;
  }
}

// s = q k^T for one warp's 16 query rows (rows r0.. of the q tile) against
// kCols keys (rows of the k tile): s[j] is the 16x8 tile of keys 8j..8j+7 in
// the mma accumulator layout, rows g, g+8 and columns 2t, 2t+1. Any two
// row-major [row][d] tiles: the backward forms q k^T, do v^T, k q^T and
// v do^T with it.
template <int D, int kCols>
__device__ __forceinline__ void tile_scores(float (&s)[kCols / 8][4], const bf16* qs, int ldq,
                                            const bf16* ks, int ldk, int r0, int g, int t) {
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* qa = qs + (r0 + g) * ldq + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ldq), ld32(qa + 8), ld32(qa + 8 * ldq + 8)};
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const bf16* kf = ks + (j * 8 + g) * ldk + kk * 16 + 2 * t;
      const uint32_t b[2] = {ld32(kf), ld32(kf + 8)};
      mma_16816(s[j], a, b);
    }
  }
}

// Copies rows [row0, row0 + kRows) of one head (D fp32 each) into a
// row-major shared tile; rows at or past n_valid are zero-filled.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_f32_rows(float* dst, int ld, const float* base,
                                              int64_t row_stride, int row0, int n_valid) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r * ld + c] = row0 + r < n_valid ? base[(int64_t)(row0 + r) * row_stride + c] : 0.f;
  }
}

// keep[r * ld + c] = 1 when score element (row0 + r, col0 + c) of `stream`
// is kept, for a kRows x kCols tile (col0 and ld multiples of 4). One Philox
// call fills 4 bytes.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void fill_keep_tile(uint8_t* keep, int ld, uint64_t seed,
                                               uint32_t stream, int row0, int col0,
                                               uint32_t threshold) {
  constexpr int kQuads = kCols / 4;
  for (int idx = threadIdx.x; idx < kRows * kQuads; idx += kThreads) {
    const int r = idx / kQuads;
    const int q = idx % kQuads;
    const uint4 b = dropout_bits4(seed, stream, (uint32_t)(row0 + r), (uint32_t)(col0 / 4 + q));
    *reinterpret_cast<uint32_t*>(keep + r * ld + 4 * q) =
        (uint32_t)(b.x <= threshold) | ((uint32_t)(b.y <= threshold) << 8) |
        ((uint32_t)(b.z <= threshold) << 16) | ((uint32_t)(b.w <= threshold) << 24);
  }
}

// The dropout of one launch: element kept when its bits <= threshold, and
// then multiplied by scale (= 1/keep).
struct Dropout {
  uint64_t seed;
  uint32_t threshold;
  float scale;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace orbit2

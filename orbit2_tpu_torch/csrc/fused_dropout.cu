// Fused elementwise dropout for Hopper (sm_90a): out = x * mult, with the
// mask made inside the kernel from a 64-bit seed, so no mask or random-bits
// tensor is ever stored and the backward saves nothing but the seed.
//
// Replaces the Pallas TPU kernel `_kernel` (orbit2_tpu/ops/dropout.py:39,
// called through `_apply` at :50). x is viewed as [rows, cols] with cols its
// last dim; element (r, c) is kept when its 16 Philox bits at (seed, stream
// 0, row r, col c) are <= t16 (csrc/kernel_prng.cuh: one call covers
// columns 8k .. 8k + 7 of a row), and then multiplied by `scale` = 1/keep.
// The product is taken in fp32 and rounded once to the output dtype. The
// backward is the same kernel on the gradient with the same seed. Any shape
// goes: no padding, no block-multiple condition and no fallback path (the TPU
// wrapper's pad/one-big-block cases, dropout.py:94-110, have no counterpart).
//
// What bounds it on the H100: one read and one write of x, 4 B an element in
// bf16 and 8 in fp32, at 3.35 TB/s (0.080 ms at [16384, 4096] bf16). The
// bits cost one Philox call (~40 integer instructions) and ~2 instructions a
// flag per 8 elements, 16 B of bf16: ~3.4 instructions a byte against the
// card's ~16.7 T integer lanes a second (132 SMs x 64 lanes x 1.98 GHz),
// ~5 T bytes a second, above the memory rate, so the design keeps the
// memory busy:
//   * a 2-D launch: a block is bdy rows x bdx threads, and thread x of a row
//     takes the 16-byte vectors x, x + bdx, ... of its row's chunk, so one
//     load instruction of a warp reads contiguous bytes and no index needs a
//     64-bit division. The host picks bdx, the power of two that covers a
//     row's vectors, up to 256; no grid-stride loop, so the launch needs no
//     SM count and the host makes no device query.
//   * each thread issues all its 16-byte loads (64 B in bf16, 128 B in
//     fp32) before it draws a bit, so 16-32 KB a block are in flight; by
//     Little's law 3.35 TB/s at ~1 us of HBM latency needs ~25 KB an SM,
//     which one of the several resident blocks already holds. Stores are
//     streaming (st.global.cs): nothing reads `out` again in this pass.
//   * one Philox call per 8 elements: a bf16 vector, or an fp32 vector pair
//     split over two lanes, which share their calls by one shuffle.
// Rows whose length is not a multiple of 8 or whose base is not 16-byte
// aligned take the scalar kernel: one call per 8 columns, element-wise
// loads, the row's ragged end masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_prng.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// 16-byte vectors a thread of the vector kernel takes: 64 B of bf16 (4
// Philox calls), 128 B of fp32 (8 vectors, 4 calls).
template <typename T>
constexpr int kVecs = sizeof(T) == 2 ? 4 : 8;

// Requires cols % 8 == 0 and 16-byte aligned x and out. Thread x of a row
// takes vectors first + i bdx (i < kVecs) of its row's chunk, so one load
// instruction of a warp covers contiguous bytes. In bf16 a vector is one
// Philox call's 8 columns. In fp32 a call's 8 columns are the vector pair
// (2u, 2u + 1), which lanes x and x ^ 1 hold (bdx is even): each lane draws
// the calls of the pairs i of its own parity and one shuffle hands it the
// flags of the others, so still one call per 8 elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int vecs_per_row,
                   uint64_t seed, uint32_t t16, float scale) {
  constexpr int kN = kVecs<T>;
  constexpr int kPerVec = 16 / (int)sizeof(T);  // elements a vector
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const int first = blockIdx.y * kN * blockDim.x + threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + (int64_t)row * vecs_per_row * kPerVec);
  uint4* dst = reinterpret_cast<uint4*>(out + (int64_t)row * vecs_per_row * kPerVec);
  uint4 v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {  // every load before any bit
    const int k = first + i * blockDim.x;
    if (live && k < vecs_per_row) v[i] = __ldg(src + k);
  }
  const uint32_t addend = orbit2::drop_addend(t16);
  uint32_t flags[kN];  // bit c: element c of vector i dropped
  if constexpr (kPerVec == 8) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      flags[i] = orbit2::shift_in_drop8(
          0u, orbit2::dropout_bits8(seed, 0u, (uint32_t)row, (uint32_t)(first + i * blockDim.x)),
          addend);
    }
  } else {
    const int odd = threadIdx.x & 1;
    uint32_t mine = 0u;  // byte j: the call of pair i = 2 j + odd
#pragma unroll
    for (int j = kN / 2 - 1; j >= 0; --j) {
      const int unit = (first - odd + (2 * j + odd) * blockDim.x) >> 1;
      mine = orbit2::shift_in_drop8(
          mine, orbit2::dropout_bits8(seed, 0u, (uint32_t)row, (uint32_t)unit), addend);
    }
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const uint32_t byte = (((i & 1) == odd ? mine : other) >> (8 * (i >> 1))) & 0xFFu;
      flags[i] = byte >> (4 * odd);
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int k = first + i * blockDim.x;
    if (live && k < vecs_per_row) {
      T* e = reinterpret_cast<T*>(&v[i]);
#pragma unroll
      for (int c = 0; c < kPerVec; ++c) {
        e[c] = from_f32<T>(to_f32(e[c]) * (((flags[i] >> c) & 1u) ? 0.f : scale));
      }
      __stcs(dst + k, v[i]);
    }
  }
}

// Any cols and alignment: a thread takes one unit of 8 columns (one Philox
// call), element-wise, masking the ragged end of its row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_scalar_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int cols,
                      uint64_t seed, uint32_t t16, float scale) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= rows || 8 * k >= cols) return;
  const int64_t base = (int64_t)row * cols + 8 * k;
  const int n = cols - 8 * k < 8 ? cols - 8 * k : 8;
  float v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = c < n ? to_f32(x[base + c]) : 0.f;
  const uint32_t dropped = orbit2::drop_flags8(seed, 0u, (uint32_t)row, (uint32_t)k, t16);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c < n) out[base + c] = from_f32<T>(v[c] * (((dropped >> c) & 1u) ? 0.f : scale));
  }
}

// A block of bdy rows x bdx threads, bdx the power of two, at least
// min_bdx, that covers `per_row` threads' work, up to kThreads.
dim3 block_for(int per_row, int min_bdx) {
  int bdx = min_bdx;
  while (bdx < per_row && bdx < kThreads) bdx *= 2;
  return dim3(bdx, kThreads / bdx);
}

template <typename T>
int launch(const void* x, void* out, int rows, int cols, uint64_t seed, uint32_t t16, float scale,
           int vec, cudaStream_t stream) {
  if (rows == 0 || cols == 0) return 0;
  if (vec) {
    const int vecs = cols / (16 / (int)sizeof(T));           // 16-byte vectors a row
    const int per_row = (vecs + kVecs<T> - 1) / kVecs<T>;  // threads a row
    const dim3 block = block_for(per_row, sizeof(T) == 4 ? 2 : 1);  // fp32: lane pairs
    const dim3 grid((rows + block.y - 1) / block.y, (per_row + block.x - 1) / block.x);
    if (grid.y > 65535) return -1;
    dropout_vec_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, vecs, seed, t16, scale);
  } else {
    const int units = (cols + 7) / 8;  // Philox calls a row
    const dim3 block = block_for(units, 1);
    const dim3 grid((rows + block.y - 1) / block.y, (units + block.x - 1) / block.x);
    if (grid.y > 65535) return -1;
    dropout_scalar_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, cols, seed, t16, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x and out are contiguous [rows, cols], rows and cols below 2^31 and a row
// at most 65535 * 256 units of 8 columns (vec: of 16-byte vectors, in 4 or 8
// a thread). vec != 0 promises
// cols % 8 == 0 and 16-byte aligned x and out. t16 is the 16-bit keep
// threshold. Returns 0 on success, a cudaError_t code if the launch failed,
// or -1 for an unknown dtype or a size out of range.
extern "C" int orbit2_fused_dropout(int dtype, const void* x, void* out, int64_t rows,
                                    int64_t cols, uint64_t seed, uint32_t t16, float scale,
                                    int vec, void* stream) {
  if (rows < 0 || cols < 0 || rows >= (1LL << 31) || cols >= (1LL << 31)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, (int)rows, (int)cols, seed, t16, scale, vec, s);
  if (dtype == 1) return launch<bf16>(x, out, (int)rows, (int)cols, seed, t16, scale, vec, s);
  return -1;
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused elementwise dropout for Hopper (sm_90a): out = x * mult, with the
// mask made inside the kernel from a 64-bit seed, so no mask or random-bits
// tensor is ever stored and the backward saves nothing but the seed.
//
// Replaces the Pallas TPU kernel `_kernel` (orbit2_tpu/ops/dropout.py:39,
// called through `_apply` at :50). x is viewed as [rows, cols] with cols its
// last dim; element (r, c) is kept when the Philox bits of (seed, stream 0,
// row r, col c) are <= threshold (csrc/kernel_prng.cuh), and then multiplied
// by `scale` = 1/keep. The product is taken in fp32 and rounded once to the
// output dtype. The backward is the same kernel on the gradient with the same
// seed. Any shape goes: no padding, no block-multiple condition and no
// fallback path (the TPU wrapper's pad/one-big-block cases, dropout.py:94-110,
// have no counterpart).
//
// What bounds it on the H100: one read and one write of x, ~4 B/element in
// bf16 and 8 in fp32, against ~25 integer ops per element for the bits
// (one Philox-4x32-10 call covers 4 elements). At 3.35 TB/s the memory side
// is ~2.5 ms per GB moved; the design keeps it a single grid-stride pass with
// 16-byte loads and stores (8 bf16 or 4 fp32 elements per thread step) where
// rows are 16-byte aligned, and element-wise loads otherwise.

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

__device__ __forceinline__ float mult_of(uint32_t bits, uint32_t threshold, float scale) {
  return bits <= threshold ? scale : 0.f;
}

// One thread step covers kVec consecutive elements of one row (two Philox
// calls for 8 bf16, one for 4 fp32), loaded and stored as one 16-byte vector.
// Requires cols % kVec == 0 and a 16-byte aligned base.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows, int64_t cols,
                   uint64_t seed, uint32_t threshold, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t per_row = cols / kVec;
  const int64_t total = rows * per_row;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / per_row;
    const int64_t c = (i % per_row) * kVec;
    uint4 raw = *reinterpret_cast<const uint4*>(x + r * cols + c);
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const uint4 b = orbit2::dropout_bits4(seed, 0u, (uint32_t)r, (uint32_t)((c >> 2) + q));
      v[4 * q + 0] = from_f32<T>(to_f32(v[4 * q + 0]) * mult_of(b.x, threshold, scale));
      v[4 * q + 1] = from_f32<T>(to_f32(v[4 * q + 1]) * mult_of(b.y, threshold, scale));
      v[4 * q + 2] = from_f32<T>(to_f32(v[4 * q + 2]) * mult_of(b.z, threshold, scale));
      v[4 * q + 3] = from_f32<T>(to_f32(v[4 * q + 3]) * mult_of(b.w, threshold, scale));
    }
    *reinterpret_cast<uint4*>(out + r * cols + c) = raw;
  }
}

// Any cols and alignment: one thread step covers one group of 4 columns
// (one Philox call), element-wise, masking the ragged end of each row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_scalar_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows, int64_t cols,
                      uint64_t seed, uint32_t threshold, float scale) {
  const int64_t per_row = (cols + 3) / 4;
  const int64_t total = rows * per_row;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / per_row;
    const int64_t c4 = i % per_row;
    const uint4 b = orbit2::dropout_bits4(seed, 0u, (uint32_t)r, (uint32_t)c4);
    const uint32_t bits[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t c = 4 * c4 + e;
      if (c < cols) {
        const int64_t at = r * cols + c;
        out[at] = from_f32<T>(to_f32(x[at]) * mult_of(bits[e], threshold, scale));
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int64_t rows, int64_t cols, uint64_t seed,
           uint32_t threshold, float scale, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t work = vec ? rows * (cols / kVec) : rows * ((cols + 3) / 4);
  if (work == 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (int64_t)sms * 16 ? want : (int64_t)sms * 16);
  if (vec) {
    dropout_vec_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, cols, seed, threshold, scale);
  } else {
    dropout_scalar_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, cols, seed, threshold, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x and out are contiguous [rows, cols]. vec != 0 promises cols % (16 /
// sizeof(dtype)) == 0 and 16-byte aligned x and out. Returns 0 on success, a
// cudaError_t code if the launch failed, or -1 for an unknown dtype.
extern "C" int orbit2_fused_dropout(int dtype, const void* x, void* out, int64_t rows,
                                    int64_t cols, uint64_t seed, uint32_t threshold,
                                    float scale, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, rows, cols, seed, threshold, scale, vec, s);
  if (dtype == 1) return launch<bf16>(x, out, rows, cols, seed, threshold, scale, vec, s);
  return -1;
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dropout bits for the port's kernels: the one definition that the
// flash-attention forward and backward kernels and the fused dropout include.
//
// Replaces `mask_bits` / `keep_mult` of the JAX package
// (orbit2_tpu/ops/kernel_prng.py:28-46). On the TPU those bits come from the
// hardware PRNG seeded per block; their interpret-mode stand-in hashes
// (block seed ^ local index), which repeats across neighbouring blocks. Here
// the bits are Philox-4x32-10 (Salmon et al., SC'11) of a counter made of
// GLOBAL coordinates, so no two elements of one call share an input and the
// forward and backward kernels regenerate the same mask whatever their tiles:
//
//   key     = (seed & 0xffffffff, seed >> 32)
//   counter = (col / 4, row, stream, 0)
//   bits of (row, col) = word (col % 4) of philox(counter, key)
//
// `stream` is the flat batch*head for attention and 0 for the fused dropout;
// `row`/`col` index the [N_q, N_k] score matrix or the [rows, cols] view of
// the dropped tensor. An element is kept when bits <= threshold, with
// threshold = uint32(keep * (2^32 - 1)) and multiplier 1/keep, as in the JAX
// package. orbit2_tpu_torch/ops/kernel_prng.py reproduces these bits exactly
// in integer torch ops (the plain version the tests and the card hold the
// kernels against).

#pragma once

#include <stdint.h>

namespace orbit2 {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The bits of columns 4*col4 .. 4*col4 + 3 of `row` in `stream`.
__device__ __forceinline__ uint4 dropout_bits4(uint64_t seed, uint32_t stream, uint32_t row,
                                               uint32_t col4) {
  return philox4x32_10(make_uint4(col4, row, stream, 0u), (uint32_t)seed,
                       (uint32_t)(seed >> 32));
}

}  // namespace orbit2

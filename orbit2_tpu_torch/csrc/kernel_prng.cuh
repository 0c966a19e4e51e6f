// Dropout bits for the port's kernels: the one definition that the
// flash-attention forward and backward kernels, the fused dropout and the
// fused MLP include.
//
// Replaces `mask_bits` / `keep_mult` of the JAX package
// (orbit2_tpu/ops/kernel_prng.py:28-46). On the TPU those bits come from the
// hardware PRNG seeded per block; their interpret-mode stand-in hashes
// (block seed ^ local index), which repeats across neighbouring blocks. Here
// the bits are Philox-4x32-10 (Salmon et al., SC'11) of a counter made of
// GLOBAL coordinates, so no two elements of one call share an input and the
// forward and backward kernels regenerate the same mask whatever their tiles.
// One call gives 8 elements 16 bits each:
//
//   key     = (seed & 0xffffffff, seed >> 32)
//   counter = (col / 8, row, stream, 0)
//   bits of (row, col) = 16-bit half col % 2 of word (col % 8) / 2
//
// `stream` is the flat batch*head for attention and 0 for the fused dropout
// and the fused MLP; `row`/`col` index the [N_q, N_k] score matrix or the
// [rows, cols] view of the dropped tensor. An element is kept when its half
// <= t16 = uint16(keep * (2^16 - 1)) (the JAX package's form at 16 bits, so
// P(keep) = (t16 + 1) / 2^16 lies within 2^-16 of keep), and then multiplied
// by 1/keep. orbit2_tpu_torch/ops/kernel_prng.py reproduces these bits
// exactly in integer torch ops (the plain version the tests and the card hold
// the kernels against).
//
// What a dropped element costs. The call is 10 rounds of two 32x32->64-bit
// products (IMAD.WIDE, FMA pipe) and two 3-input xors (LOP3, ALU pipe); the
// round keys depend on the seed alone, so the compiler already computes them
// once in the uniform datapath. The compare is a carry: a half h of word w
// is dropped when h + (0xffff - t16) carries out of 16 bits, so
// `add.cc` of the half (in the word's top 16 bits) and (0xffff - t16) << 16,
// then `addc acc, acc, acc` shifts that carry into a word of flags: two
// instructions a flag, one on each pipe (IADD3 or, with the low half's
// shift folded in, LEA with carry out; IMAD.X), and no mask or pack. A word
// of drop flags holds 4 calls: bit 8 k + (col % 8) for the k-th call. In
// K1's SASS this is 7.9 integer instructions a dropped element, against 13.9
// for 4 elements of 32 bits a call (PERF.md).

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

// The bits of columns 8*col8 .. 8*col8 + 7 of `row` in `stream`: the 16-bit
// half c % 2 of word c / 2 is column 8*col8 + c.
__device__ __forceinline__ uint4 dropout_bits8(uint64_t seed, uint32_t stream, uint32_t row,
                                               uint32_t col8) {
  return philox4x32_10(make_uint4(col8, row, stream, 0u), (uint32_t)seed,
                       (uint32_t)(seed >> 32));
}

// The addend whose carry out of a 16-bit half marks a dropped element: a
// half h in the top 16 bits of x carries out of x + drop_addend(t16) exactly
// when h > t16.
__device__ __forceinline__ uint32_t drop_addend(uint32_t t16) { return (0xFFFFu - t16) << 16; }

// acc = 2 acc + (the high half of w is dropped).
__device__ __forceinline__ void shift_in_drop_hi(uint32_t& acc, uint32_t w, uint32_t addend) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\taddc.u32 %0, %0, %0;\n\t}"
      : "+r"(acc)
      : "r"(w), "r"(addend));
}

// acc = 2 acc + (the low half of w is dropped), for words 0 and 2 of a call
// (the round's xors): the shift inside the asm folds into the carry-out add,
// one LEA.
__device__ __forceinline__ void shift_in_drop_lo(uint32_t& acc, uint32_t w, uint32_t addend) {
  asm("{\n\t.reg .u32 t;\n\tshl.b32 t, %1, 16;\n\tadd.cc.u32 t, t, %2;\n\t"
      "addc.u32 %0, %0, %0;\n\t}"
      : "+r"(acc)
      : "r"(w), "r"(addend));
}

// The same for words 1 and 3 (the last round's low products): a shift there
// lets the compiler multiply anew by the shifted constant and split the
// round's wide product, two FMA-pipe instructions more a word, so the halves
// are swapped by a byte permute instead (PRMT), which it leaves alone.
__device__ __forceinline__ void shift_in_drop_lo_of_product(uint32_t& acc, uint32_t w,
                                                            uint32_t addend) {
  asm("{\n\t.reg .u32 t;\n\tprmt.b32 t, %1, 0, 0x1032;\n\tadd.cc.u32 t, t, %2;\n\t"
      "addc.u32 %0, %0, %0;\n\t}"
      : "+r"(acc)
      : "r"(w), "r"(addend));
}

// (acc << 8) | the drop flags of one call's 8 elements: bit c for column
// 8*col8 + c of `bits` (dropout_bits8).
__device__ __forceinline__ uint32_t shift_in_drop8(uint32_t acc, uint4 bits, uint32_t addend) {
  shift_in_drop_hi(acc, bits.w, addend);  // column 7
  shift_in_drop_lo_of_product(acc, bits.w, addend);
  shift_in_drop_hi(acc, bits.z, addend);
  shift_in_drop_lo(acc, bits.z, addend);
  shift_in_drop_hi(acc, bits.y, addend);
  shift_in_drop_lo_of_product(acc, bits.y, addend);
  shift_in_drop_hi(acc, bits.x, addend);
  shift_in_drop_lo(acc, bits.x, addend);  // column 0
  return acc;
}

// The drop flags of columns 8*col8 .. 8*col8 + 7 (bit c for column 8*col8 + c).
__device__ __forceinline__ uint32_t drop_flags8(uint64_t seed, uint32_t stream, uint32_t row,
                                                uint32_t col8, uint32_t t16) {
  return shift_in_drop8(0u, dropout_bits8(seed, stream, row, col8), drop_addend(t16));
}

}  // namespace orbit2

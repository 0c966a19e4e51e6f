// Attention probes for Hopper (sm_90a): the flash forward (K1, bf16) with
// what happens between its two products replaced, to say where its time goes.
//
// Replaces the Pallas TPU probes of scripts/bench_attn2.py, all on q, k, v
// [BH, N, 64] bf16, o [BH, N, 64] bf16, sums in fp32:
//   orbit2_probe_matmul_only   `_kern_matmul_only` (:47):  o = bf16(q k^T) v
//   orbit2_probe_exp_noreduce  `_kern_exp_noreduce` (:56): o = bf16(exp2(q k^T - 20)) v
//   orbit2_probe_full_softmax  `_kern_full_softmax` (:66): m = rowmax(s),
//       p = exp2(s - m), o = (bf16(p) v) / rowsum(p), s = q k^T unscaled
//   orbit2_probe_bound_shift   `_kern_bound_shift` (:78):  p = exp2(qs k^T - b),
//       o = (bf16(p) v) / rowsum(bf16(p)), with qs = q pre-scaled by
//       D^-1/2 log2(e) and b the per-row bound |qs_i| max_j |k_j| [BH, N] fp32
// The TPU kernels hold all of kv in one block (BK = N = 2048).
//
// What bounds them on the H100. 4 BH N^2 D flops for the two products (137.4
// GFLOP at BH 128, N 2048: 0.139 ms at 989 TFLOP/s) against 134 MB of q, k,
// v and o (0.040 ms at 3.35 TB/s): the matrix units. Beside them S1b, S1c and
// S2 take BH N^2 exp2 on the special-function units (537 M at that shape).
//
// Design. Each probe is a Variant of K1's kernel template,
// flash_fwd_tma_wgmma in flash_fwd_hopper.cuh (TMA ring, producer warp, two
// wgmma consumer warpgroups of 64 query rows, 128-key tiles), so the ladder
// K1 > S1c > S1b > S1a is a decomposition of K1 on this card: the loads,
// barriers and both products are K1's own, and only the work on s between
// them differs. [BH, N, 64] is K1's [B = BH, N, H = 1, D = 64]. What the TPU
// design does not carry over:
//   * BK = N does not fit: k alone is 256 KB at N = 2048, over the 227 KB a
//     block may use. kv streams in tiles. S1a, S1b and S2 are linear in p once
//     the shift is fixed, so streaming is exact up to summation order.
//   * S1c needs the row max before any exp2 and cannot hold the row, so it
//     sweeps kv twice: q k^T for the row max (k tiles alone), then exp2, the
//     row sum and the value product. It does 1.5x the products of the others;
//     its rate is still counted on the useful 4 BH N^2 D, as the script
//     counts it.
//   * S2 takes the bound as [BH, N] fp32 (not replicated over 128 lanes) and v
//     without the ones column: l is the row sum of the bf16-rounded p taken in
//     registers, the quantity the ones column summed on the MXU, without 64
//     product columns of ones.
// N must be a multiple of 64 (the JAX grid needs N % BQ == 0); a last kv tile
// of 64 keys is masked as K1 masks its ragged tile.

#include "flash_fwd_hopper.cuh"

namespace {

using orbit2::hopper::Variant;

template <int P>
int launch(const void* q, const void* k, const void* v, const void* bound, void* o,
           const int64_t* strides, int64_t bh, int64_t n, void* stream) {
  if (n < 64 || n % 64 != 0 || n > INT32_MAX || bh < 1 || bh > 65535) return -1;
  const orbit2::hopper::Params prm{static_cast<orbit2::bf16*>(o), nullptr,
                                   static_cast<const float*>(bound), 1, (int)n, (int)n, 1.f,
                                   orbit2::Dropout{0, 0, 0.f}};
  return orbit2::hopper::launch<64, P, false>(q, k, v, strides, bh, prm,
                                              static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points, bound with ctypes. q (qs for the bound shift), k and
// v are [bh, n, 64] bf16 as K1's [B = bh, N = n, H = 1, 64], with element
// strides {b, n, h} each in `strides` (9 values) and TMA's alignment (the
// wrapper copies an operand that breaks it); o is contiguous [bh, n, 64]
// bf16, bound contiguous [bh, n] fp32. Each returns 0 on success, a
// cudaError_t code if the launch failed, -1 for a shape it has no instance
// for (n not a positive multiple of 64, bh outside [1, 65535]), or -2 when
// the driver refuses a tensor map.
extern "C" int orbit2_probe_matmul_only(const void* q, const void* k, const void* v, void* o,
                                        const int64_t* strides, int64_t bh, int64_t n,
                                        void* stream) {
  return launch<Variant::kMatmulOnly>(q, k, v, nullptr, o, strides, bh, n, stream);
}

extern "C" int orbit2_probe_exp_noreduce(const void* q, const void* k, const void* v, void* o,
                                         const int64_t* strides, int64_t bh, int64_t n,
                                         void* stream) {
  return launch<Variant::kExpNoReduce>(q, k, v, nullptr, o, strides, bh, n, stream);
}

extern "C" int orbit2_probe_full_softmax(const void* q, const void* k, const void* v, void* o,
                                         const int64_t* strides, int64_t bh, int64_t n,
                                         void* stream) {
  return launch<Variant::kFullSoftmax>(q, k, v, nullptr, o, strides, bh, n, stream);
}

extern "C" int orbit2_probe_bound_shift(const void* qs, const void* k, const void* v,
                                        const void* bound, void* o, const int64_t* strides,
                                        int64_t bh, int64_t n, void* stream) {
  return launch<Variant::kBoundShift>(qs, k, v, bound, o, strides, bh, n, stream);
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Attention probes for Hopper (sm_90a): the flash forward (flash_attn_fwd.cu,
// bf16) stripped one part at a time, to say where its time goes.
//
// Replaces the Pallas TPU probes of scripts/bench_attn2.py, all on q, k, v
// [BH, N, 64] bf16 contiguous, o [BH, N, 64] bf16, sums in fp32:
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
// Design. Each probe is K1's bf16 kernel with parts removed, so that the
// ladder K1 > S1c > S1b > S1a is a decomposition of K1 on this card: one
// block owns one (bh, 64-query tile), 4 warps of 16 query rows each; k and v
// stream through shared memory in 64-row tiles (v transposed); both products
// are the tile_scores / tile_pv of flash_common.cuh on mma.sync m16n8k16,
// with the scores kept in registers as the A operand of p v. What the TPU
// design does not carry over:
//   * BK = N does not fit: k alone is 256 KB at N = 2048, over the 227 KB a
//     block may use. kv streams in tiles. S1a, S1b and S2 are linear in p once
//     the shift is fixed, so streaming is exact up to summation order.
//   * S1c needs the row max before any exp2 and cannot hold the row, so it
//     sweeps kv twice: q k^T for the row max, then exp2, the row sum and the
//     value product. It does 1.5x the products of the others; its rate is
//     still counted on the useful 4 BH N^2 D, as the script counts it.
//   * S2 takes the bound as [BH, N] fp32 (not replicated over 128 lanes) and v
//     without the ones column: l is the row sum of the bf16-rounded p taken in
//     registers, the quantity the ones column summed on the MXU, without 64
//     product columns of ones.
// N must be a multiple of 64 (the JAX grid needs N % BQ == 0), so there are
// no ragged tiles to mask.

#include "flash_common.cuh"

namespace {

using orbit2::bf16;
using orbit2::pack_bf16x2;

constexpr int kD = 64;
constexpr int kBlock = 64;      // query rows of a block, keys of a kv tile
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kLd = kD + 8;     // q/k tiles [row][d]; the padding keeps
constexpr int kLdVt = kBlock + 8;  // fragment loads free of bank conflicts
constexpr int kNT = kBlock / 8;  // score n-tiles per kv tile
constexpr int kDT = kD / 8;      // output n-tiles

enum Probe { kMatmulOnly, kExpNoReduce, kFullSoftmax, kBoundShift };

template <int P>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const float* __restrict__ bound, bf16* __restrict__ o, int n, int vec) {
  constexpr bool kNormalize = P == kFullSoftmax || P == kBoundShift;
  __shared__ __align__(16) bf16 qs[kBlock * kLd];
  __shared__ __align__(16) bf16 ks[kBlock * kLd];
  __shared__ __align__(16) bf16 vt[kD * kLdVt];

  const int64_t head = (int64_t)blockIdx.y * n * kD;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  const int q0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int r0 = (threadIdx.x / 32) * 16;

  orbit2::load_bf16_rows<kD, kBlock, kThreads>(qs, kLd, q + head, kD, q0, n, vec);

  // what exp2 subtracts from the rows g and g + 8 of this thread: S1b's fixed
  // 20, else the row max (S1c) or the row bound (S2) set below
  float shift[2] = {20.f, 20.f};
  if constexpr (P == kBoundShift) {
#pragma unroll
    for (int r = 0; r < 2; ++r) shift[r] = bound[(int64_t)blockIdx.y * n + q0 + r0 + g + 8 * r];
  }
  if constexpr (P == kFullSoftmax) {  // first sweep: the row max of q k^T
    shift[0] = shift[1] = -INFINITY;
    for (int k0 = 0; k0 < n; k0 += kBlock) {
      __syncthreads();  // the previous tile's k reads are done
      orbit2::load_bf16_rows<kD, kBlock, kThreads>(ks, kLd, kb, kD, k0, n, vec);
      __syncthreads();
      float s[kNT][4];
      orbit2::tile_scores<kD, kBlock>(s, qs, kLd, ks, kLd, r0, g, t);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) shift[e >> 1] = fmaxf(shift[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 4 threads are lanes 4g..4g+3
      shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 1));
      shift[r] = fmaxf(shift[r], __shfl_xor_sync(0xffffffffu, shift[r], 2));
    }
  }

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int k0 = 0; k0 < n; k0 += kBlock) {
    __syncthreads();  // the previous tile's k/v reads are done
    orbit2::load_bf16_rows<kD, kBlock, kThreads>(ks, kLd, kb, kD, k0, n, vec);
    orbit2::load_bf16_rows_transposed<kD, kBlock, kThreads>(vt, kLdVt, vb, kD, k0, n, vec);
    __syncthreads();

    float s[kNT][4];
    orbit2::tile_scores<kD, kBlock>(s, qs, kLd, ks, kLd, r0, g, t);
    if constexpr (P != kMatmulOnly) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[j][e] - shift[e >> 1]);
          // S2 sums the bf16 p that goes into the product (the ones column);
          // S1c sums the fp32 p
          if constexpr (P == kBoundShift) p = __bfloat162float(__float2bfloat16_rn(p));
          if constexpr (kNormalize) l[e >> 1] += p;
          s[j][e] = p;
        }
      }
    }
    orbit2::tile_pv<kD, kBlock>(acc, s, vt, kLdVt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = 1.f;
    if constexpr (kNormalize) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den = l[r];
    }
    bf16* orow = o + head + (int64_t)(q0 + r0 + g + 8 * r) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
    }
  }
}

template <int P>
int launch(const void* q, const void* k, const void* v, const void* bound, void* o, int64_t bh,
           int64_t n, int vec, void* stream) {
  if (n < kBlock || n % kBlock != 0 || n > INT32_MAX || bh < 1 || bh > 65535) return -1;
  probe_kernel<P><<<dim3((unsigned)(n / kBlock), (unsigned)bh), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bound), static_cast<bf16*>(o), (int)n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. q (qs for the bound shift), k, v
// and o are contiguous [bh, n, 64] bf16, bound contiguous [bh, n] fp32.
// vec != 0 promises 16-byte aligned q, k and v (tiles are then loaded with
// 16-byte loads). Each returns 0 on success, a cudaError_t code if the launch
// failed, or -1 for a shape it has no instance for (n not a positive multiple
// of 64, bh outside [1, 65535]).
extern "C" int orbit2_probe_matmul_only(const void* q, const void* k, const void* v, void* o,
                                        int64_t bh, int64_t n, int vec, void* stream) {
  return launch<kMatmulOnly>(q, k, v, nullptr, o, bh, n, vec, stream);
}

extern "C" int orbit2_probe_exp_noreduce(const void* q, const void* k, const void* v, void* o,
                                         int64_t bh, int64_t n, int vec, void* stream) {
  return launch<kExpNoReduce>(q, k, v, nullptr, o, bh, n, vec, stream);
}

extern "C" int orbit2_probe_full_softmax(const void* q, const void* k, const void* v, void* o,
                                         int64_t bh, int64_t n, int vec, void* stream) {
  return launch<kFullSoftmax>(q, k, v, nullptr, o, bh, n, vec, stream);
}

extern "C" int orbit2_probe_bound_shift(const void* qs, const void* k, const void* v,
                                        const void* bound, void* o, int64_t bh, int64_t n,
                                        int vec, void* stream) {
  return launch<kBoundShift>(qs, k, v, bound, o, bh, n, vec, stream);
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

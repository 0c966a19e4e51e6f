// Flash-attention forward for Hopper (sm_90a), non-causal.
//
// Replaces the Pallas TPU kernels `_fwd_kernel_oneshot` and `_fwd_kernel`
// (orbit2_tpu/ops/flash_attention.py:117-198): o = softmax(q k^T * scale) v
// with fp32 accumulation and an online softmax in base 2, plus the base-2
// logsumexp lse = m + log2(l) per query row, stored as fp32 [B*H, N_q]
// (the TPU's (BH, 8, N) sublane replication is dropped).
//
// Layout: q [B, N_q, H, D], k/v [B, N_k, H, D] are read through their strides
// (the last dim must be contiguous), so the views of a packed qkv projection
// feed the kernel with no copy. o is written contiguous [B, N_q, H, D].
//
// Design. One block owns one (batch*head, 64-query tile); k/v stream through
// shared memory in 64-row tiles, so N_k is bounded only by the loop, not by
// on-chip memory, and one code path serves the one-shot and the streaming
// cases of the TPU kernels. Ragged tails are masked in-kernel: kv columns
// past N_k get p = 0 and their tile rows are zero-filled; query rows past
// N_q are computed and not stored.
//
// What bounds it on the H100. At head dims 64-256 attention does about
// 2 N_k D flops per loaded q element, so it is bound by the matrix units,
// not by HBM. The two products therefore run on the tensor cores where the
// inputs allow it:
//   * bf16 (the serving dtype): 4 warps, 16 query rows each, issue
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate). Scores stay in registers:
//     the accumulator layout of q k^T is the A-operand layout of p v, so p
//     never goes through shared memory. v is stored transposed in shared
//     memory so its B fragments are single 32-bit loads; rows are padded by
//     16 bytes so fragment loads are free of bank conflicts.
//   * fp32: the tensor cores have no full-fp32 mode (TF32 keeps 10 mantissa
//     bits), so 256 threads, four per query row, do the products with fp32
//     FMAs from fp32 tiles in shared memory, exact to fp32 rounding and bound
//     by shared-memory bandwidth.
// wgmma with TMA-fed, double-buffered tiles is the next step for the bf16
// path. The fp32 tiles at D = 256 take 213,760 bytes of shared memory, above
// the 48 KB static limit, so every launch raises the dynamic shared-memory
// limit with cudaFuncSetAttribute.
//
// Dropout (drop_rate > 0, the kDropout instances; drop_rate == 0 compiles to
// the kernels without any of it). As in the TPU kernels (:183-187) dropout
// comes after the softmax normalizer: l and lse sum the undropped p, and only
// the p of the value product is multiplied by the {0, 1/keep} mask. The mask
// of each 64 x 64 score tile is regenerated from the seed and the global
// (query, key) coordinates (csrc/kernel_prng.cuh, stream = batch*head) into
// a byte tile in shared memory, one Philox call per 4 bytes, so each thread
// reads its elements in the mma accumulator layout (the A-fragment layout
// of p v) and the backward kernels regenerate the same mask with their own
// tiling.

#include "flash_common.cuh"

namespace {

using orbit2::bf16;
using orbit2::Dropout;
using orbit2::pack_bf16x2;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kKeepLd = kBlockK + 4;  // byte row stride of the keep tile
constexpr size_t kKeepBytes = (size_t)kBlockQ * kKeepLd;

// ---- bf16: tensor cores (mma.sync m16n8k16) -------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int D>
struct MmaTiles {
  static constexpr int kLd = D + 8;          // q/k tiles [row][d], bf16
  static constexpr int kLdVt = kBlockK + 8;  // transposed v tile [d][kv], bf16
  static constexpr size_t kBytes = sizeof(bf16) * (kBlockQ * kLd + kBlockK * kLd + D * kLdVt);
};

template <int D, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int heads, int n_q, int n_k, int64_t sqb, int64_t sqn, int64_t sqh,
                     int64_t skb, int64_t skn, int64_t skh, int64_t svb, int64_t svn,
                     int64_t svh, float scale_log2, int vec, Dropout drop) {
  using L = MmaTiles<D>;
  constexpr int kNT = kBlockK / 8;  // score n-tiles per kv tile
  constexpr int kDT = D / 8;        // output n-tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBlockQ * L::kLd;
  bf16* vt = ks + kBlockK * L::kLd;
  uint8_t* keep = reinterpret_cast<uint8_t*>(smem_raw + L::kBytes);  // kDropout only

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int r0 = (threadIdx.x / 32) * 16;

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;

  orbit2::load_bf16_rows<D, kBlockQ, kMmaThreads>(qs, L::kLd, qb, sqn, q0, n_q, vec);

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_k; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k/v reads are done
    orbit2::load_bf16_rows<D, kBlockK, kMmaThreads>(ks, L::kLd, kb, skn, k0, n_k, vec);
    orbit2::load_bf16_rows_transposed<D, kBlockK, kMmaThreads>(vt, L::kLdVt, vb, svn, k0, n_k,
                                                               vec);
    if constexpr (kDropout) {
      orbit2::fill_keep_tile<kBlockQ, kBlockK, kMmaThreads>(keep, kKeepLd, drop.seed, bh, q0, k0,
                                                            drop.threshold);
    }
    __syncthreads();

    // s = q k^T: s[j] is the 16x8 tile of kv columns 8j..8j+7; this thread
    // holds rows g, g+8 and columns 2t, 2t+1 of each
    float s[kNT][4];
    orbit2::tile_scores<D, kBlockK>(s, qs, L::kLd, ks, L::kLd, r0, g, t);

    // online softmax in base 2; a row's 4 threads are lanes 4g..4g+3
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = col < n_k ? s[j][e] * scale_log2 : -INFINITY;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m[r], m_tile[r]);  // finite: every tile has a valid column
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        row_sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      l[r] = l[r] * alpha[r] + row_sum[r];
    }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    if constexpr (kDropout) {  // after the normalizer: l keeps the undropped p
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r0 + g + 8 * (e >> 1);
          const int cl = j * 8 + 2 * t + (e & 1);
          s[j][e] *= keep[rl * kKeepLd + cl] ? drop.scale : 0.f;
        }
      }
    }

    // acc += p v: the score tiles 2kk, 2kk+1 are the A fragment of kv step kk
    orbit2::tile_pv<D, kBlockK>(acc, s, vt, L::kLdVt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi < n_q) {
      const float inv_l = 1.f / l[r];
      bf16* orow = o + (((int64_t)b * n_q + qi) * heads + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16x2(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
      }
      if (t == 0) lse[(int64_t)bh * n_q + qi] = m[r] + log2f(l[r]);
    }
  }
}

// ---- fp32: FMAs ------------------------------------------------------------

constexpr int kThreadsPerRow = 4;
constexpr int kFmaThreads = kBlockQ * kThreadsPerRow;  // 256

template <int D>
struct FmaTiles {
  static constexpr int kLdQ = D + 1;  // one word of padding: conflict-free reads
  static constexpr int kLdK = D + 1;
  static constexpr int kLdV = D;
  static constexpr int kLdP = kBlockK + 1;
  static constexpr size_t kBytes =
      sizeof(float) * (kBlockQ * kLdQ + kBlockK * kLdK + kBlockK * kLdV + kBlockQ * kLdP);
};

template <int D, bool kDropout>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int n_q, int n_k, int64_t sqb,
                     int64_t sqn, int64_t sqh, int64_t skb, int64_t skn, int64_t skh,
                     int64_t svb, int64_t svn, int64_t svh, float scale_log2, Dropout drop) {
  using L = FmaTiles<D>;
  constexpr int kCols = kBlockK / kThreadsPerRow;  // score columns per thread
  constexpr int kOut = D / kThreadsPerRow;         // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * L::kLdQ;
  float* vs = ks + kBlockK * L::kLdK;
  float* ps = vs + kBlockK * L::kLdV;
  uint8_t* keep = reinterpret_cast<uint8_t*>(smem + L::kBytes / sizeof(float));  // kDropout only

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x % kThreadsPerRow;

  orbit2::load_f32_rows<D, kBlockQ, kFmaThreads>(qs, L::kLdQ, q + b * sqb + h * sqh, sqn, q0,
                                                 n_q);
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const float* qrow = qs + row * L::kLdQ;
  const float* prow = ps + row * L::kLdP;

  for (int k0 = 0; k0 < n_k; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k/v/p reads are done
    orbit2::load_f32_rows<D, kBlockK, kFmaThreads>(ks, L::kLdK, kb, skn, k0, n_k);
    orbit2::load_f32_rows<D, kBlockK, kFmaThreads>(vs, L::kLdV, vb, svn, k0, n_k);
    if constexpr (kDropout) {
      orbit2::fill_keep_tile<kBlockQ, kBlockK, kFmaThreads>(keep, kKeepLd, drop.seed, bh, q0, k0,
                                                            drop.threshold);
    }
    __syncthreads();

    // s = q k^T for this thread's columns sub, sub + 4, ...
    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qv = qrow[c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = fmaf(qv, ks[(sub + kThreadsPerRow * j) * L::kLdK + c], s[j]);
    }

    // online softmax in base 2; the 4 threads of a row are adjacent lanes
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = k0 + sub + kThreadsPerRow * j;
      s[j] = col < n_k ? s[j] * scale_log2 : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);  // finite: every tile has a valid column
    const float alpha = exp2f(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int cl = sub + kThreadsPerRow * j;
      const float p = exp2f(s[j] - m_new);
      row_sum += p;  // the normalizer sums the undropped p
      if constexpr (kDropout) {
        ps[row * L::kLdP + cl] = p * (keep[row * kKeepLd + cl] ? drop.scale : 0.f);
      } else {
        ps[row * L::kLdP + cl] = p;
      }
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] *= alpha;
    __syncthreads();  // the whole row of p is in shared memory

    // acc += p v for this thread's output columns sub, sub + 4, ...
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      const float p = prow[j];
      const float* vrow = vs + j * L::kLdV + sub;
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] = fmaf(p, vrow[kThreadsPerRow * i], acc[i]);
    }
  }

  const int qi = q0 + row;
  if (qi < n_q) {
    const float inv_l = 1.f / l;
    float* orow = o + (((int64_t)b * n_q + qi) * heads + h) * D + sub;
#pragma unroll
    for (int i = 0; i < kOut; ++i) orow[kThreadsPerRow * i] = acc[i] * inv_l;
    if (sub == 0) lse[(int64_t)bh * n_q + qi] = m + log2f(l);
  }
}

// ---- launch -----------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int64_t batch, heads, n_q, n_k;
  const int64_t* s;  // {q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h}
  float scale_log2;
  int vec;
  Dropout drop;
  cudaStream_t stream;
};

dim3 grid_of(const Args& a) {
  return dim3((unsigned)((a.n_q + kBlockQ - 1) / kBlockQ), (unsigned)(a.batch * a.heads));
}

template <int D, bool kDropout>
int launch_bf16(const Args& a) {
  const size_t smem = MmaTiles<D>::kBytes + (kDropout ? kKeepBytes : 0);
  cudaError_t err = orbit2::allow_smem(flash_fwd_mma_kernel<D, kDropout>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_mma_kernel<D, kDropout><<<grid_of(a), kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, (int)a.heads,
      (int)a.n_q, (int)a.n_k, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7],
      a.s[8], a.scale_log2, a.vec, a.drop);
  return (int)cudaGetLastError();
}

template <int D, bool kDropout>
int launch_f32(const Args& a) {
  const size_t smem = FmaTiles<D>::kBytes + (kDropout ? kKeepBytes : 0);
  cudaError_t err = orbit2::allow_smem(flash_fwd_fma_kernel<D, kDropout>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_fma_kernel<D, kDropout><<<grid_of(a), kFmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, (int)a.heads,
      (int)a.n_q, (int)a.n_k, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7],
      a.s[8], a.scale_log2, a.drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const Args& a, bool dropout) {
  if (dtype == 1) return dropout ? launch_bf16<D, true>(a) : launch_bf16<D, false>(a);
  return dropout ? launch_f32<D, true>(a) : launch_f32<D, false>(a);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: {q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h} in elements.
// vec != 0 promises that every row of q/k/v starts 16-byte aligned (bf16
// tiles are then loaded with 16-byte loads). dropout != 0 drops attention
// probabilities: kept when the bits of (seed, batch*head, query, key) are
// <= drop_threshold, then scaled by drop_scale. Returns 0 on success, a
// cudaError_t code if the launch failed, or -1 for a dtype or head dim the
// kernel has no instance for.
extern "C" int orbit2_flash_attn_fwd(int dtype, int64_t head_dim, const void* q, const void* k,
                                     const void* v, void* o, void* lse, int64_t batch,
                                     int64_t heads, int64_t n_q, int64_t n_k,
                                     const int64_t* strides, double sm_scale, int vec,
                                     int dropout, uint64_t seed, uint32_t drop_threshold,
                                     float drop_scale, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, heads, n_q, n_k, strides,
               (float)(sm_scale * 1.4426950408889634), vec,
               Dropout{seed, drop_threshold, drop_scale}, static_cast<cudaStream_t>(stream)};
  if (dtype != 0 && dtype != 1) return -1;
  switch (head_dim) {
    case 64: return launch<64>(dtype, a, dropout != 0);
    case 128: return launch<128>(dtype, a, dropout != 0);
    case 256: return launch<256>(dtype, a, dropout != 0);
  }
  return -1;
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

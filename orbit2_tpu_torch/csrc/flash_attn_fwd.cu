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
// feed the kernel with no copy. o is written contiguous [B, N_q, H, D]. kv
// columns past N_k get p = 0; query rows past N_q are computed and not stored.
//
// Two kernels:
//   * bf16 (the serving and training dtype): flash_fwd_tma_wgmma of
//     flash_fwd_hopper.cuh, TMA loads into a ring of k/v stages, one producer
//     warp, two consumer warpgroups on wgmma, dropout bits in registers. Its
//     header says what bounds it and how it is laid out.
//   * fp32, the parity dtype: the tensor cores have no full-fp32 mode (TF32
//     keeps 10 mantissa bits), so 256 threads, four per query row, do the
//     products with fp32 FMAs from fp32 tiles in shared memory, exact to fp32
//     rounding and bound by shared-memory bandwidth. One block owns one
//     (batch*head, 64-query tile) and k/v stream through shared memory in
//     64-row tiles. The tiles at D = 256 take 213,760 bytes of shared memory,
//     above the 48 KB static limit, so every launch raises the dynamic
//     shared-memory limit with cudaFuncSetAttribute.
//
// Dropout (drop_rate > 0, the kDropout instances; drop_rate == 0 compiles to
// the kernels without any of it). As in the TPU kernels (:183-187) dropout
// comes after the softmax normalizer: l and lse sum the undropped p, and only
// the p of the value product is multiplied by the {0, 1/keep} mask of
// csrc/kernel_prng.cuh at (seed, stream = batch*head, query, key), which the
// backward kernels regenerate with their own tiling. The fp32 kernel fills a
// byte tile of the mask in shared memory, one Philox call per 8 bytes.

#include "flash_common.cuh"
#include "flash_fwd_hopper.cuh"

namespace {

using orbit2::Dropout;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kKeepLd = kBlockK + 4;  // byte row stride of the keep tile
constexpr size_t kKeepBytes = (size_t)kBlockQ * kKeepLd;

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
  Dropout drop;
  cudaStream_t stream;
};

template <int D, bool kDropout>
int launch_bf16(const Args& a) {
  const orbit2::hopper::Params prm{static_cast<orbit2::bf16*>(a.o), a.lse, nullptr, (int)a.heads,
                                   (int)a.n_q, (int)a.n_k, a.scale_log2, a.drop};
  return orbit2::hopper::launch<D, orbit2::hopper::kFlash, kDropout>(a.q, a.k, a.v, a.s, a.batch,
                                                                     prm, a.stream);
}

template <int D, bool kDropout>
int launch_f32(const Args& a) {
  const size_t smem = FmaTiles<D>::kBytes + (kDropout ? kKeepBytes : 0);
  cudaError_t err = orbit2::allow_smem(flash_fwd_fma_kernel<D, kDropout>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.n_q + kBlockQ - 1) / kBlockQ), (unsigned)(a.batch * a.heads));
  flash_fwd_fma_kernel<D, kDropout><<<grid, kFmaThreads, smem, a.stream>>>(
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
// strides: {q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h} in elements; for
// bf16 the base pointers must be 16-byte aligned and the strides multiples
// of 8 (TMA's rule; the wrapper copies an operand that breaks it). dropout
// != 0 drops attention probabilities: kept when the 16 bits of (seed,
// batch*head, query, key) are <= drop_threshold, then scaled by drop_scale.
// Returns 0 on success, a cudaError_t code if the launch failed, -1 for a
// dtype or head dim the kernel has no instance for, or -2 when the driver
// refuses a bf16 operand's tensor map.
extern "C" int orbit2_flash_attn_fwd(int dtype, int64_t head_dim, const void* q, const void* k,
                                     const void* v, void* o, void* lse, int64_t batch,
                                     int64_t heads, int64_t n_q, int64_t n_k,
                                     const int64_t* strides, double sm_scale, int dropout,
                                     uint64_t seed, uint32_t drop_threshold, float drop_scale,
                                     void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, heads, n_q, n_k, strides,
               (float)(sm_scale * 1.4426950408889634), Dropout{seed, drop_threshold, drop_scale},
               static_cast<cudaStream_t>(stream)};
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

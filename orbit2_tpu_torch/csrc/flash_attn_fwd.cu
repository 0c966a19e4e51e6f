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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
using bf16 = __nv_bfloat16;

// ---- bf16: tensor cores (mma.sync m16n8k16) -------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int D>
struct MmaTiles {
  static constexpr int kLd = D + 8;          // q/k tiles [row][d], bf16
  static constexpr int kLdVt = kBlockK + 8;  // transposed v tile [d][kv], bf16
  static constexpr size_t kBytes = sizeof(bf16) * (kBlockQ * kLd + kBlockK * kLd + D * kLdVt);
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b for one 16x8 tile: a 16x16 (row), b 16x8 (col), bf16 in, fp32 acc
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies rows [row0, row0 + 64) of one head into shared memory, 8 elements
// per step (16-byte loads when `vec`), zero-filling rows at or past n_valid.
// kTranspose stores element (r, c) at dst[c * ld + r].
template <int D, bool kTranspose>
__device__ __forceinline__ void load_bf16_tile(bf16* dst, int ld, const bf16* base,
                                               int64_t row_stride, int row0, int n_valid,
                                               bool vec) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    bf16* vals = reinterpret_cast<bf16*>(&chunk);
    if (row0 + r < n_valid) {
      const bf16* src = base + (int64_t)(row0 + r) * row_stride + c;
      if (vec) {
        chunk = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vals[i] = src[i];
      }
    }
    if (kTranspose) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * ld + r] = vals[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = chunk;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int heads, int n_q, int n_k, int64_t sqb, int64_t sqn, int64_t sqh,
                     int64_t skb, int64_t skn, int64_t skh, int64_t svb, int64_t svn,
                     int64_t svh, float scale_log2, int vec) {
  using L = MmaTiles<D>;
  constexpr int kNT = kBlockK / 8;  // score n-tiles per kv tile
  constexpr int kDT = D / 8;        // output n-tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBlockQ * L::kLd;
  bf16* vt = ks + kBlockK * L::kLd;

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

  load_bf16_tile<D, false>(qs, L::kLd, qb, sqn, q0, n_q, vec);

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_k; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k/v reads are done
    load_bf16_tile<D, false>(ks, L::kLd, kb, skn, k0, n_k, vec);
    load_bf16_tile<D, true>(vt, L::kLdVt, vb, svn, k0, n_k, vec);
    __syncthreads();

    // s = q k^T: s[j] is the 16x8 tile of kv columns 8j..8j+7; this thread
    // holds rows g, g+8 and columns 2t, 2t+1 of each
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = qs + (r0 + g) * L::kLd + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * L::kLd), ld32(qa + 8),
                             ld32(qa + 8 * L::kLd + 8)};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* kf = ks + (j * 8 + g) * L::kLd + kk * 16 + 2 * t;
        const uint32_t bfrag[2] = {ld32(kf), ld32(kf + 8)};
        mma_16816(s[j], a, bfrag);
      }
    }

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

    // acc += p v: the score tiles 2kk, 2kk+1 are the A fragment of kv step kk
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const bf16* vf = vt + (j * 8 + g) * L::kLdVt + kk * 16 + 2 * t;
        const uint32_t bfrag[2] = {ld32(vf), ld32(vf + 8)};
        mma_16816(acc[j], a, bfrag);
      }
    }
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

// Copies rows [row0, row0 + 64) of one head into shared memory; rows at or
// past n_valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_f32_tile(float* dst, int ld, const float* base,
                                              int64_t row_stride, int row0, int n_valid) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kFmaThreads) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r * ld + c] = row0 + r < n_valid ? base[(int64_t)(row0 + r) * row_stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int n_q, int n_k, int64_t sqb,
                     int64_t sqn, int64_t sqh, int64_t skb, int64_t skn, int64_t skh,
                     int64_t svb, int64_t svn, int64_t svh, float scale_log2) {
  using L = FmaTiles<D>;
  constexpr int kCols = kBlockK / kThreadsPerRow;  // score columns per thread
  constexpr int kOut = D / kThreadsPerRow;         // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * L::kLdQ;
  float* vs = ks + kBlockK * L::kLdK;
  float* ps = vs + kBlockK * L::kLdV;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x % kThreadsPerRow;

  load_f32_tile<D>(qs, L::kLdQ, q + b * sqb + h * sqh, sqn, q0, n_q);
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
    load_f32_tile<D>(ks, L::kLdK, kb, skn, k0, n_k);
    load_f32_tile<D>(vs, L::kLdV, vb, svn, k0, n_k);
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
      const float p = exp2f(s[j] - m_new);
      row_sum += p;
      ps[row * L::kLdP + sub + kThreadsPerRow * j] = p;
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
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_of(const Args& a) {
  return dim3((unsigned)((a.n_q + kBlockQ - 1) / kBlockQ), (unsigned)(a.batch * a.heads));
}

template <int D>
int launch_bf16(const Args& a) {
  const size_t smem = MmaTiles<D>::kBytes;
  cudaError_t err = prepare(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_mma_kernel<D><<<grid_of(a), kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, (int)a.heads,
      (int)a.n_q, (int)a.n_k, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7],
      a.s[8], a.scale_log2, a.vec);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a) {
  const size_t smem = FmaTiles<D>::kBytes;
  cudaError_t err = prepare(flash_fwd_fma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_fma_kernel<D><<<grid_of(a), kFmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, (int)a.heads,
      (int)a.n_q, (int)a.n_k, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.s[6], a.s[7],
      a.s[8], a.scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: {q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h} in elements.
// vec != 0 promises that every row of q/k/v starts 16-byte aligned (bf16
// tiles are then loaded with 16-byte loads). Returns 0 on success, a
// cudaError_t code if the launch failed, or -1 for a dtype or head dim the
// kernel has no instance for.
extern "C" int orbit2_flash_attn_fwd(int dtype, int64_t head_dim, const void* q, const void* k,
                                     const void* v, void* o, void* lse, int64_t batch,
                                     int64_t heads, int64_t n_q, int64_t n_k,
                                     const int64_t* strides, double sm_scale, int vec,
                                     void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, heads, n_q, n_k, strides,
               (float)(sm_scale * 1.4426950408889634), vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch_bf16<64>(a);
      case 128: return launch_bf16<128>(a);
      case 256: return launch_bf16<256>(a);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
      case 256: return launch_f32<256>(a);
    }
  }
  return -1;
}

extern "C" const char* orbit2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

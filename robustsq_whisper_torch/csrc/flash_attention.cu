// Row-major flash-attention forward for training, with the log-sum-exp.
//
// Replaces the TPU kernel `_attn_kernel` (JAX package,
// ops/flash_attention.py, wrapper `_fwd_impl`, entry `flash_attention`):
// softmax(Q K^T / sqrt(d) + mask) V with an f32 online softmax over K/V
// tiles, ragged key tails masked, and lse = m + log(l) (f32, natural log)
// written per query row for the backward (flash_attention_bwd.cu).
// Operands are the contiguous (batch, T, heads, 64) tensors of the model;
// the kernel reads them with their own strides, so the (b * h, T, d)
// transposes of the TPU wrapper never happen.
//
// Bound on the card: operations. At the Whisper-medium training shape
// (b * h = 128, T = 1516, d = 64) the call does 4 * bh * T^2 * d = 75 GFLOP
// against 99 MB of bf16 operands; its 2.9e8 exp2 take about as long again
// on the special-function unit.
//
// bf16 runs the Hopper kernel of flash_fwd_sm90.cuh in its ROWS layout:
// wgmma with Q and K read K-major and V N-major from swizzled shared
// memory, 128-byte rows loaded with 16-byte cp.async by a loader
// warpgroup into an mbarrier ring, consumer warpgroups of 64 queries (three
// unmasked, two masked) taking turns on the tensor cores so one's softmax
// runs under the others' products. A row whose scores are all -inf so far (a -inf mask) uses 0 as
// its reference maximum, so no exp2(-inf - -inf) is taken. The additive
// f32 mask (broadcast (b, h, q, kv) through strides) is the kernel's MASK
// instantiation, read per score.
//
// f32 inputs (the tests' exact path) run a plain SIMT kernel: one thread
// per query, K/V tiles in shared memory.

#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"

using namespace flash;

namespace {

// ---- f32: exact SIMT ----

constexpr int BQ = 128;  // queries per block = threads per block
constexpr int BK = 32;   // keys per shared-memory tile

template <bool MASK>
__global__ void __launch_bounds__(BQ)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ mask,
                         float* __restrict__ o, float* __restrict__ lse, int heads,
                         int q_len, int kv_len, MaskStrides ms, float scale_log2) {
  __shared__ __align__(16) float ks[BK * KS];
  __shared__ __align__(16) float vs[BK * KS];
  const int qi = blockIdx.x * BQ + threadIdx.x;
  const bool live = qi < q_len;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const size_t stride = (size_t)heads * HD;
  const float* kh = k + (size_t)bi * kv_len * stride + hi * HD;
  const float* vh = v + (size_t)bi * kv_len * stride + hi * HD;
  const size_t q_row = ((size_t)bi * q_len + (live ? qi : 0)) * stride + hi * HD;
  const size_t m_off = (size_t)bi * ms.b + (size_t)hi * ms.h;

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = live ? q[q_row + c] * scale_log2 : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();
    load_rows_f32(ks, kh, stride, k0, BK, kv_len);
    load_rows_f32(vs, vh, stride, k0, BK, kv_len);
    __syncthreads();
    const int nk = min(BK, kv_len - k0);
    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float x = dot64(qr, ks + j * KS);
      if (MASK && live && j < nk) x += mask_log2<MASK>(mask, m_off, ms, qi, k0 + j);
      s[j] = j < nk ? x : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    const float ref = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - ref);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - ref);
      l += p;
      axpy64(acc, p, vs + j * KS);
    }
    m = m_new;
  }
  if (live) {
    l = fmaxf(l, 1e-30f);
    const float inv = 1.f / l;
    float* orow = o + q_row;
#pragma unroll
    for (int c = 0; c < HD; ++c) orow[c] = acc[c] * inv;
    lse[(size_t)bh * q_len + qi] =
        m == -INFINITY ? -1e30f : m * 0.6931471805599453f + logf(l);
  }
}

template <bool MASK>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* o,
            float* lse, int bh, int heads, int q_len, int kv_len, MaskStrides ms,
            int dtype, float scale_log2, cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((q_len + BQ - 1) / BQ, bh);
    flash_fwd_f32_kernel<MASK><<<grid, BQ, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, mask, (float*)o, lse,
        heads, q_len, kv_len, ms, scale_log2);
  } else {
    namespace f = flash::sm90;
    const f::Params p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, mask,
                      heads, q_len, kv_len, ms, scale_log2};
    return f::launch<f::Rows, MASK, true>(p, bh, st);
  }
  return cudaGetLastError();
}

}  // namespace

// q, o: (batch, q_len, heads, 64); k, v: (batch, kv_len, heads, 64); all
// contiguous, 16-byte aligned, dtype 0 = f32, 1 = bf16. mask: null or f32
// read at b * smb + h * smh + query * smq + key * smk. lse: f32 (batch,
// heads, q_len). Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* mask, void* o, void* lse, int batch,
                               int heads, int q_len, int kv_len, int head_dim,
                               int smb, int smh, int smq, int smk, int dtype,
                               void* stream) {
  const int bh = batch * heads;
  if (head_dim != HD || q_len <= 0 || kv_len <= 0 || bh <= 0 || bh > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = LOG2E / sqrtf((float)head_dim);
  const MaskStrides ms{smb, smh, smq, smk};
  cudaStream_t st = (cudaStream_t)stream;
  if (mask)
    return (int)launch<true>(q, k, v, (const float*)mask, o, (float*)lse, bh, heads,
                             q_len, kv_len, ms, dtype, scale_log2, st);
  return (int)launch<false>(q, k, v, nullptr, o, (float*)lse, bh, heads, q_len, kv_len,
                            ms, dtype, scale_log2, st);
}

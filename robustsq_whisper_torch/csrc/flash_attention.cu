// Row-major flash-attention forward for training, with the log-sum-exp.
//
// Replaces the TPU kernel `_attn_kernel` (JAX package,
// ops/flash_attention.py, wrapper `_fwd_impl`, entry `flash_attention`):
// softmax(Q K^T / sqrt(d) + mask) V with an f32 online softmax over K/V
// tiles, ragged key tails masked, and lse = m + log(l) (f32, natural log)
// written per query row for the backward (flash_attention_bwd.cu).
// Operands are the contiguous (batch, T, heads, 64) tensors of the model;
// the kernel reads them with their own strides (flash_common.cuh), so the
// (b * h, T, d) transposes of the TPU wrapper never happen.
//
// Bound on the card: operations. At the Whisper-medium training shape
// (b * h = 128, T = 1516, d = 64) the call does 4 * bh * T^2 * d = 75 GFLOP
// against 99 MB of bf16 operands.
//
// bf16 runs on the tensor cores with mma.sync m16n8k16 (f32 accumulation),
// FlashAttention-2 style: one block of 4 warps per (64-query tile, b * h),
// 16 queries a warp, 64-key K and V tiles staged in shared memory with the
// next tile's loads in flight (registers) during the current tile's math.
// S = Q K^T takes K rows with a plain ldmatrix, O += P V takes V rows with
// the transposing one; P is the f32 score exponent rounded to bf16, as in
// flash_attention_tmaj.cu. Keys at or past kv_len score -inf and load as 0.
// A row whose scores are all -inf so far (a -inf mask) uses 0 as its
// reference maximum, so no exp2(-inf - -inf) is taken.
//
// The additive f32 mask (broadcast (b, h, q, kv) through strides) is the
// second instantiation of each kernel: it is read per element of each
// (query tile, key tile) product. f32 inputs (the tests' exact path) run a
// plain SIMT kernel: one thread per query, K/V tiles in shared memory.

#include "flash_common.cuh"

using namespace flash;

namespace {

template <bool MASK>
__global__ void __launch_bounds__(128)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                         int heads, int q_len, int kv_len, MaskStrides ms,
                         float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[TILE * LD];  // Q, later O
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TILE;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const size_t stride = (size_t)heads * HD;
  const __nv_bfloat16* qh = q + (size_t)bi * q_len * stride + hi * HD;
  const __nv_bfloat16* kh = k + (size_t)bi * kv_len * stride + hi * HD;
  const __nv_bfloat16* vh = v + (size_t)bi * kv_len * stride + hi * HD;
  const size_t m_off = (size_t)bi * ms.b + (size_t)hi * ms.h;

  RowTile kt, vt;
  kt.load(qh, stride, q0, q_len);  // the Q tile goes through kt first
  kt.store(qs);
  kt.load(kh, stride, 0, kv_len);
  vt.load(vh, stride, 0, kv_len);
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) load_a(qa[kc], qs, 16 * warp, 16 * kc, lane);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (log2 units)
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial sums
  const int r_lo = q0 + 16 * warp + (lane >> 2), r_hi = r_lo + 8;

  for (int k0 = 0; k0 < kv_len; k0 += TILE) {
    __syncthreads();  // the previous K/V tiles are consumed
    kt.store(ks);
    vt.store(vs);
    __syncthreads();
    if (k0 + TILE < kv_len) {
      kt.load(kh, stride, k0 + TILE, kv_len);
      vt.load(vh, stride, k0 + TILE, kv_len);
    }

    float s[8][4];
    mma_rows_nk(s, qa, ks, lane);  // S = Q K^T, 16 queries x 64 keys

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        float x = s[n][e] * scale_log2;
        if (MASK && row < q_len && key < kv_len)
          x += mask_log2<MASK>(mask, m_off, ms, row, key);
        s[n][e] = key < kv_len ? x : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // a row sits in a lane quad
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float ref_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
    const float ref_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float a_lo = exp2f(m_lo - ref_lo), a_hi = exp2f(m_hi - ref_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
      s[n][0] = exp2f(s[n][0] - ref_lo);
      s[n][1] = exp2f(s[n][1] - ref_lo);
      s[n][2] = exp2f(s[n][2] - ref_hi);
      s[n][3] = exp2f(s[n][3] - ref_hi);
      l_lo += s[n][0] + s[n][1];
      l_hi += s[n][2] + s[n][3];
    }
    uint32_t pa[4][4];
    acc_to_a(pa, s);
    mma_rows_kn(acc, pa, vs, lane);  // O += P V
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  l_lo = fmaxf(l_lo, 1e-30f);
  l_hi = fmaxf(l_hi, 1e-30f);
  if ((lane & 3) == 0) {
    const float ln2 = 0.6931471805599453f;
    if (r_lo < q_len)
      lse[(size_t)bh * q_len + r_lo] = m_lo == -INFINITY ? -1e30f : m_lo * ln2 + logf(l_lo);
    if (r_hi < q_len)
      lse[(size_t)bh * q_len + r_hi] = m_hi == -INFINITY ? -1e30f : m_hi * ln2 + logf(l_hi);
  }
  // O through the Q buffer (each warp owns its 16 rows there), then stored
  // row by row
  stage_rows(qs, acc, 16 * warp, lane, 1.f / l_lo, 1.f / l_hi);
  __syncthreads();
  RowTile::write(o + (size_t)bi * q_len * stride + hi * HD, stride, qs, q0, q_len);
}

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
void launch(const void* q, const void* k, const void* v, const float* mask, void* o,
            float* lse, int bh, int heads, int q_len, int kv_len, MaskStrides ms,
            int dtype, float scale_log2, cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((q_len + BQ - 1) / BQ, bh);
    flash_fwd_f32_kernel<MASK><<<grid, BQ, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, mask, (float*)o, lse,
        heads, q_len, kv_len, ms, scale_log2);
  } else {
    const dim3 grid((q_len + TILE - 1) / TILE, bh);
    flash_fwd_mma_kernel<MASK><<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        mask, (__nv_bfloat16*)o, lse, heads, q_len, kv_len, ms, scale_log2);
  }
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
    launch<true>(q, k, v, (const float*)mask, o, (float*)lse, bh, heads, q_len,
                 kv_len, ms, dtype, scale_log2, st);
  else
    launch<false>(q, k, v, nullptr, o, (float*)lse, bh, heads, q_len, kv_len, ms,
                  dtype, scale_log2, st);
  return (int)cudaGetLastError();
}

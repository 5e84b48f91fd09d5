// Encoder self-attention in the transposed (b*h, head_dim, T) layout.
//
// Replaces the TPU kernel `_attn_kernel_tmaj` (JAX package,
// ops/flash_attention.py, entry `flash_attention_tmaj`): unmasked
// softmax(Q K^T / sqrt(d)) V with an f32 online softmax, ragged T masked
// inside the kernel, time the contiguous axis of every operand.
//
// Bound on the card: operations. At Whisper-medium (T = 1516, d = 64) one
// (batch, head) pair does 4 * T^2 * d = 0.59 GFLOP against 0.78 MB of
// bf16 operands, far above the H100's ~295 FLOP/byte ridge; the T^2 exp2
// of the softmax take about as long again on the special-function unit.
//
// bf16 (the serving dtype) runs the Hopper kernel of flash_fwd_sm90.cuh
// in its TMAJ layout: wgmma with Q read M-major, K N-major and V K-major
// from swizzled shared memory, K/V loaded by a loader warpgroup with
// cp.async along T (16-, 8- or 4-byte words as t_len's alignment allows,
// 2-byte loads for odd t_len; TMA needs 16-byte strides, which T = 1516
// does not give) into an mbarrier ring, and three consumer warpgroups of 64
// queries, each one's softmax running while the others' products do. The same
// kernel serves the row-major training forward (flash_attention.cu), with
// the same summation order.
//
// f32 inputs (the tests' exact path) run a plain SIMT kernel: one thread
// per query, q and its accumulator in registers, K/V tiles in shared
// memory transposed to (key, channel) so every thread reads the same row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int HD = 64;  // head_dim (every Whisper size)
constexpr float LOG2E = 1.4426950408889634f;

// ---- f32: exact SIMT ----

constexpr int BQ = 128;     // queries per block = threads per block
constexpr int BK = 32;      // keys per shared-memory tile
constexpr int KS = HD + 4;  // padded tile row stride in floats (16 B aligned)

__global__ void __launch_bounds__(BQ)
    flash_tmaj_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int t_len, float scale_log2) {
  __shared__ __align__(16) float ks[BK * KS];
  __shared__ __align__(16) float vs[BK * KS];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * BQ + tid;
  const bool live = qi < t_len;
  const size_t base = (size_t)blockIdx.y * HD * t_len;

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    // scores are kept in log2 units: exp2(s * log2 e) == exp(s)
    qr[c] = live ? q[base + (size_t)c * t_len + qi] * scale_log2 : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * HD; e += BQ) {
      const int c = e / BK, j = e % BK;  // j fastest: coalesced along T
      const int t = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < t_len) {
        kv = k[base + (size_t)c * t_len + t];
        vv = v[base + (size_t)c * t_len + t];
      }
      ks[j * KS + c] = kv;
      vs[j * KS + c] = vv;
    }
    __syncthreads();
    const int nk = min(BK, t_len - k0);

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * KS);
      float a = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < HD / 4; ++c4) {
        const float4 kk = kr[c4];
        a = fmaf(qr[4 * c4 + 0], kk.x, a);
        a = fmaf(qr[4 * c4 + 1], kk.y, a);
        a = fmaf(qr[4 * c4 + 2], kk.z, a);
        a = fmaf(qr[4 * c4 + 3], kk.w, a);
      }
      s[j] = j < nk ? a : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    // m_new is finite (nk >= 1); exp2(-inf) = 0 on the first tile
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * KS);
#pragma unroll
      for (int c4 = 0; c4 < HD / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
      }
    }
    m = m_new;
  }
  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < HD; ++c) o[base + (size_t)c * t_len + qi] = acc[c] * inv;
  }
}

}  // namespace

// q, k, v, o: (bh, head_dim, t_len) contiguous, dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_tmaj(const void* q, const void* k,
                                    const void* v, void* o, int bh,
                                    int head_dim, int t_len, int dtype,
                                    void* stream) {
  if (head_dim != HD || t_len <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = LOG2E / sqrtf((float)head_dim);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((t_len + BQ - 1) / BQ, bh);
    flash_tmaj_f32_kernel<<<grid, BQ, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, t_len,
        scale_log2);
  } else if (dtype == 1) {
    namespace f = flash::sm90;
    const f::Params p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, nullptr, nullptr,
                      1, t_len, t_len, {0, 0, 0, 0}, scale_log2};
    // the widest word along T that keeps every word aligned (16-byte base
    // pointers) and wholly inside [0, t_len) or wholly past it
    if (t_len % 8 == 0) return (int)f::launch<f::Tmaj<16>, false, false>(p, bh, st);
    if (t_len % 4 == 0) return (int)f::launch<f::Tmaj<8>, false, false>(p, bh, st);
    if (t_len % 2 == 0) return (int)f::launch<f::Tmaj<4>, false, false>(p, bh, st);
    return (int)f::launch<f::Tmaj<2>, false, false>(p, bh, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Shared pieces of the row-major flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu, sm90.cuh): the head
// dimension, the mask strides, bf16 packing and the f32 SIMT helpers.
//
// Operands are contiguous (batch, T, heads, head_dim = 64): row t of head
// (b, h) starts at ((b * T + t) * heads + h) * 64, so a row is 128 bytes and
// consecutive rows of one head are heads * 64 elements apart. The kernels
// read that layout directly; nothing is transposed to (b * h, T, d).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int HD = 64;  // head_dim (every Whisper size)
constexpr float LOG2E = 1.4426950408889634f;

// Additive f32 mask strides in elements, broadcast as (b, h, q, kv); zero
// strides broadcast an axis.
struct MaskStrides {
  int b, h, q, k;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- f32 SIMT helpers ----

constexpr int KS = HD + 4;  // padded f32 row stride (16-byte aligned rows)

// rows [r0, r0 + n) of one f32 head into a shared (n, KS) tile; rows at or
// past n_rows are zero. Threads walk the channels of a row: coalesced.
__device__ __forceinline__ void load_rows_f32(float* s, const float* __restrict__ head,
                                              size_t stride, int r0, int n,
                                              int n_rows) {
  for (int e = threadIdx.x; e < n * HD; e += blockDim.x) {
    const int j = e / HD, c = e % HD;
    s[j * KS + c] = r0 + j < n_rows ? head[(size_t)(r0 + j) * stride + c] : 0.f;
  }
}

__device__ __forceinline__ float dot64(const float* x, const float* s_row) {
  const float4* r = reinterpret_cast<const float4*>(s_row);
  float a = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < HD / 4; ++c4) {
    const float4 v = r[c4];
    a = fmaf(x[4 * c4 + 0], v.x, a);
    a = fmaf(x[4 * c4 + 1], v.y, a);
    a = fmaf(x[4 * c4 + 2], v.z, a);
    a = fmaf(x[4 * c4 + 3], v.w, a);
  }
  return a;
}

__device__ __forceinline__ void axpy64(float* acc, float w, const float* s_row) {
  const float4* r = reinterpret_cast<const float4*>(s_row);
#pragma unroll
  for (int c4 = 0; c4 < HD / 4; ++c4) {
    const float4 v = r[c4];
    acc[4 * c4 + 0] = fmaf(w, v.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(w, v.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(w, v.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(w, v.w, acc[4 * c4 + 3]);
  }
}

// The additive mask at (b, h, query, key) in log2 units; 0 without a mask.
template <bool MASK>
__device__ __forceinline__ float mask_log2(const float* __restrict__ mask,
                                           size_t head_off, MaskStrides ms,
                                           int query, int key) {
  if (!MASK) return 0.f;
  return mask[head_off + (size_t)query * ms.q + (size_t)key * ms.k] * LOG2E;
}

}  // namespace flash

// One-query self attention over the dense flat decode cache.
//
// Replaces the TPU kernel `_kernel` (JAX package, ops/self_attention.py,
// entry `decode_self_attention`, two-leaf dense cache): for each batch row
// and head, softmax([q . K_cache[0, pos); q . k_new] / sqrt(d)) over
// [V_cache[0, pos); v_new], with the cache stored flat as (layers, batch,
// T_pad, n_state) and the layer's slab picked by `layer_idx`. The new
// token's K/V are separate operands and merge last, as on the TPU.
//
// Bound on the card: bytes. Each (row, head) reads 2 * pos * d cache
// values and does ~4 pos d operations on them: 1 operation per byte.
//
// Design (first version): one block of 4 warps per (head, row). A warp
// takes one cache position at a time; each lane holds 2 of the head's 64
// channels, so a warp reads the position's 128-byte K and V rows in one
// coalesced access each, and the per-head score is a warp shuffle
// reduction (the TPU kernel used 0/1 head-map matmuls instead). Each warp
// keeps its own f32 online-softmax state; warp 0 merges the 4 states and
// the new token. `layer_idx` and `pos` are device scalars read here.
// pos == 0 is legal: no cache position is read and the output is exactly
// v_new.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;  // head_dim: 2 channels per lane
constexpr int WARPS = 4;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float2 x, float* p) {
  *reinterpret_cast<float2*>(p) = x;
}
__device__ __forceinline__ void store2(float2 x, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    decode_self_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                       const T* __restrict__ vn, const T* __restrict__ kc,
                       const T* __restrict__ vc,
                       const int* __restrict__ layer_idx,
                       const int* __restrict__ pos_ptr, T* __restrict__ out,
                       int batch, int heads, int t_pad) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_a[WARPS][HD];
  const int hi = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_state = heads * HD;
  const int layer = *layer_idx;
  const int pos = max(0, min(*pos_ptr, t_pad));
  const float scale = 1.f / sqrtf((float)HD);

  const size_t row = (size_t)bi * n_state + hi * HD + 2 * lane;
  float2 qv = load2(q + row);
  qv.x *= scale;
  qv.y *= scale;
  const size_t cbase =
      ((size_t)layer * batch + bi) * t_pad * n_state + hi * HD + 2 * lane;

  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int t = warp; t < pos; t += WARPS) {
    const size_t off = cbase + (size_t)t * n_state;
    const float2 kv = load2(kc + off);
    const float2 vv = load2(vc + off);
    const float s = warp_sum(qv.x * kv.x + qv.y * kv.y);
    const float m_new = fmaxf(m, s);
    const float alpha = __expf(m - m_new);  // 0 while m is -inf
    const float p = __expf(s - m_new);
    l = l * alpha + p;
    a0 = a0 * alpha + p * vv.x;
    a1 = a1 * alpha + p * vv.y;
    m = m_new;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_a[warp][2 * lane] = a0;
  sm_a[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (warp != 0) return;

  const float2 kv = load2(kn + row);
  const float2 vv = load2(vn + row);
  const float s_new = warp_sum(qv.x * kv.x + qv.y * kv.y);
  float m_fin = s_new;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m_fin = fmaxf(m_fin, sm_m[w]);
  const float p_new = expf(s_new - m_fin);
  float den = p_new, n0 = p_new * vv.x, n1 = p_new * vv.y;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    // a warp that saw no position holds m = -inf and contributes nothing
    const float alpha = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - m_fin);
    den += sm_l[w] * alpha;
    n0 += sm_a[w][2 * lane] * alpha;
    n1 += sm_a[w][2 * lane + 1] * alpha;
  }
  store2(make_float2(n0 / den, n1 / den), out + row);
}

}  // namespace

// q, k_new, v_new, out: (batch, n_state); k_cache, v_cache: (layers, batch,
// t_pad, n_state), n_state = heads * head_dim, all contiguous, dtype 0 = f32,
// 1 = bf16. layer_idx, pos: device int32 scalars. Returns
// cudaGetLastError() after the launch.
extern "C" int decode_self_attention(const void* q, const void* k_new,
                                     const void* v_new, const void* k_cache,
                                     const void* v_cache, const void* layer_idx,
                                     const void* pos, void* out, int batch,
                                     int heads, int head_dim, int t_pad,
                                     int dtype, void* stream) {
  if (head_dim != HD || t_pad <= 0 || batch <= 0 || batch > 65535 ||
      heads <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(heads, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    decode_self_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        (const float*)q, (const float*)k_new, (const float*)v_new,
        (const float*)k_cache, (const float*)v_cache, (const int*)layer_idx,
        (const int*)pos, (float*)out, batch, heads, t_pad);
  } else if (dtype == 1) {
    decode_self_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new,
        (const __nv_bfloat16*)v_new, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, (const int*)layer_idx,
        (const int*)pos, (__nv_bfloat16*)out, batch, heads, t_pad);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

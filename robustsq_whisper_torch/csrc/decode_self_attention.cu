// One-query self attention over the dense flat decode cache.
//
// Replaces the TPU kernel `_kernel` (JAX package, ops/self_attention.py,
// entry `decode_self_attention`, two-leaf dense cache): for each batch row
// and head, softmax([q . K_cache[0, pos); q . k_new] / sqrt(d)) over
// [V_cache[0, pos); v_new], with the cache stored flat as (layers, batch,
// T_pad, n_state) and the layer's slab picked by `layer_idx`. The new
// token's K/V are separate operands and merge last, as on the TPU.
//
// The int8 cache (the TPU kernel's `quantized` branch, entry
// `decode_self_attention_int8`) holds int8 K and V and one bf16 (layers,
// batch, T_pad, 128) scale leaf: per (position, head), K's scale in lane
// `head` and V's in lane `heads + head`. The K scale multiplies the score
// after the dot; the V scale multiplies the softmax weight before the V
// sum, while the normaliser l sums the raw weights. The new token's K/V are
// exact and merge last.
//
// Bound on the card: bytes. Each (row, head) reads 2 * pos * d cache
// values (bf16 or f32; int8 plus two scales) and does ~4 pos d operations
// on them.
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
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int HD = 64;  // head_dim: 2 channels per lane
constexpr int WARPS = 4;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
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

// C is the cache's element type: T (dense) or int8_t (then `sc` holds the
// scales).
template <typename T, typename C>
__global__ void __launch_bounds__(WARPS * 32)
    decode_self_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                       const T* __restrict__ vn, const C* __restrict__ kc,
                       const C* __restrict__ vc,
                       const __nv_bfloat16* __restrict__ sc,
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
  const size_t slab = ((size_t)layer * batch + bi) * t_pad;
  const size_t cbase = slab * n_state + hi * HD + 2 * lane;
  constexpr bool QUANT = std::is_same<C, int8_t>::value;

  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int t = warp; t < pos; t += WARPS) {
    const size_t off = cbase + (size_t)t * n_state;
    const float2 kv = load2(kc + off);
    const float2 vv = load2(vc + off);
    float s = warp_sum(qv.x * kv.x + qv.y * kv.y);
    float ks = 1.f, vs = 1.f;
    if constexpr (QUANT) {
      const __nv_bfloat16* row_sc = sc + (slab + t) * 128;
      ks = __bfloat162float(row_sc[hi]);
      vs = __bfloat162float(row_sc[heads + hi]);
      s *= ks;
    }
    const float m_new = fmaxf(m, s);
    const float alpha = __expf(m - m_new);  // 0 while m is -inf
    const float p = __expf(s - m_new);
    const float pv = QUANT ? p * vs : p;
    l = l * alpha + p;
    a0 = a0 * alpha + pv * vv.x;
    a1 = a1 * alpha + pv * vv.y;
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

template <typename T, typename C>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_cache, const void* v_cache, const void* scales,
           const void* layer_idx, const void* pos, void* out, int batch,
           int heads, int t_pad, void* stream) {
  const dim3 grid(heads, batch);
  decode_self_kernel<T, C><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (const C*)k_cache,
      (const C*)v_cache, (const __nv_bfloat16*)scales, (const int*)layer_idx,
      (const int*)pos, (T*)out, batch, heads, t_pad);
  return (int)cudaGetLastError();
}

bool bad_shape(int batch, int heads, int head_dim, int t_pad) {
  return head_dim != HD || t_pad <= 0 || batch <= 0 || batch > 65535 ||
         heads <= 0;
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
  if (bad_shape(batch, heads, head_dim, t_pad)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, float>(q, k_new, v_new, k_cache, v_cache, nullptr,
                                layer_idx, pos, out, batch, heads, t_pad,
                                stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_new, v_new, k_cache, v_cache, nullptr, layer_idx, pos, out,
        batch, heads, t_pad, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 cache: k8, v8 int8 (layers, batch, t_pad, n_state), scales bf16
// (layers, batch, t_pad, 128) with K's scale of head h in lane h and V's in
// lane heads + h (2 heads <= 128). q, k_new, v_new, out as above, dtype 0 =
// f32, 1 = bf16.
extern "C" int decode_self_attention_int8(
    const void* q, const void* k_new, const void* v_new, const void* k8,
    const void* v8, const void* scales, const void* layer_idx,
    const void* pos, void* out, int batch, int heads, int head_dim,
    int t_pad, int dtype, void* stream) {
  if (bad_shape(batch, heads, head_dim, t_pad) || 2 * heads > 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, int8_t>(q, k_new, v_new, k8, v8, scales, layer_idx,
                                 pos, out, batch, heads, t_pad, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, k_new, v_new, k8, v8, scales,
                                         layer_idx, pos, out, batch, heads,
                                         t_pad, stream);
  return (int)cudaErrorInvalidValue;
}

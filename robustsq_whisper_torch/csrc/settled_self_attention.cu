// Online-softmax state over the settled cache prefix, read through a
// per-row indirection (the deferred beam reorder).
//
// Replaces the TPU kernel `_settled_kernel` (JAX package,
// ops/self_attention.py, entry `settled_self_attention`): for each logical
// row i and head, the unnormalised state (m, l, acc) of q_i's attention
// over positions [0, settled) of PHYSICAL cache row row_map[i] in layer
// slab `layer_idx` of the flat (layers, rows_phys, T_pad, n_state) cache:
// m = max score, l = sum exp(s - m), acc = sum exp(s - m) v, all f32. The
// caller merges it with the window's and the new token's states. With
// settled == 0 no position is read and the state is (-1e30, 0, 0); its
// weight in the merge is exactly 0, as that of the TPU kernel's one
// all-masked group is.
//
// Bound on the card: bytes. Each (row, head) reads 2 * settled * d cache
// values and does ~4 settled d operations on them: 1 operation per byte.
//
// Design (first version), that of decode_self_attention.cu: one block of
// 4 warps per (head, logical row), which reads row_map[i] once; a warp
// takes one cache position at a time, each lane holds 2 of the head's 64
// channels, so a warp reads the position's 128-byte K and V rows in one
// coalesced access each and the score is a warp shuffle reduction. Each
// warp keeps its own online-softmax state; warp 0 merges the 4 and writes
// the state instead of a normalised output. On the GPU the indirection is
// only a pointer offset. `layer_idx` and `settled` are device scalars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;  // head_dim: 2 channels per lane
constexpr int WARPS = 4;
constexpr float NEG = -1e30f;  // the JAX package's mask value

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    settled_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ layer_idx,
                   const int* __restrict__ settled_ptr,
                   const int* __restrict__ row_map, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   int rows_phys, int heads, int t_pad) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_a[WARPS][HD];
  const int hi = blockIdx.x, ri = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_state = heads * HD;
  const int layer = *layer_idx;
  const int settled = max(0, min(*settled_ptr, t_pad));
  const int phys = row_map[ri];
  const float scale = 1.f / sqrtf((float)HD);

  const size_t row = (size_t)ri * n_state + hi * HD + 2 * lane;
  float2 qv = load2(q + row);
  qv.x *= scale;
  qv.y *= scale;
  const size_t cbase =
      ((size_t)layer * rows_phys + phys) * t_pad * n_state + hi * HD + 2 * lane;

  float m = NEG, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int t = warp; t < settled; t += WARPS) {
    const size_t off = cbase + (size_t)t * n_state;
    const float2 kv = load2(kc + off);
    const float2 vv = load2(vc + off);
    const float s = warp_sum(qv.x * kv.x + qv.y * kv.y);
    const float m_new = fmaxf(m, s);
    const float alpha = __expf(m - m_new);  // 0 while m is NEG
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

  float m_fin = NEG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m_fin = fmaxf(m_fin, sm_m[w]);
  float den = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    // a warp that saw no position holds (NEG, 0, 0) and adds nothing
    const float alpha = expf(sm_m[w] - m_fin);
    den += sm_l[w] * alpha;
    n0 += sm_a[w][2 * lane] * alpha;
    n1 += sm_a[w][2 * lane + 1] * alpha;
  }
  if (lane == 0) {
    m_out[(size_t)ri * heads + hi] = m_fin;
    l_out[(size_t)ri * heads + hi] = den;
  }
  *reinterpret_cast<float2*>(acc_out + row) = make_float2(n0, n1);
}

}  // namespace

// q: (rows, n_state); k_cache, v_cache: (layers, rows_phys, t_pad,
// n_state), n_state = heads * head_dim, all contiguous, dtype 0 = f32,
// 1 = bf16. layer_idx, settled: device int32 scalars; row_map: (rows,)
// device int32, each in [0, rows_phys). m, l: (rows, heads) f32; acc:
// (rows, n_state) f32. Returns cudaGetLastError() after the launch.
extern "C" int settled_self_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* layer_idx,
                                      const void* settled, const void* row_map,
                                      void* m, void* l, void* acc, int rows,
                                      int rows_phys, int heads, int head_dim,
                                      int t_pad, int dtype, void* stream) {
  if (head_dim != HD || t_pad <= 0 || rows <= 0 || rows > 65535 ||
      rows_phys <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(heads, rows);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    settled_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        (const float*)q, (const float*)k_cache, (const float*)v_cache,
        (const int*)layer_idx, (const int*)settled, (const int*)row_map,
        (float*)m, (float*)l, (float*)acc, rows_phys, heads, t_pad);
  } else if (dtype == 1) {
    settled_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
        (const __nv_bfloat16*)v_cache, (const int*)layer_idx,
        (const int*)settled, (const int*)row_map, (float*)m, (float*)l,
        (float*)acc, rows_phys, heads, t_pad);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One-query cross attention over quantized encoder K/V (the decode loop).
//
// Replaces the TPU kernels `_kernel` (group 1) and `_kernel_grouped`
// (group > 1) of the JAX package's ops/decode_attention.py, entry
// `decode_cross_attention`: softmax(q . K) V for `group` queries per
// (batch, head) against K/V stored transposed as (layers, batch, heads,
// d[/2], T_pad), the layer's slab picked by `layer_idx` and positions >=
// `kv_len` masked. With group > 1 the queries are the beams of one
// utterance and share its one K/V read. Storage is packed int4 (two
// channels a byte: channel i in the low nibble, i + d/2 in the high one),
// int8, bf16 or f32. The caller folds every scale: q arrives pre-scaled by
// d^-0.5 * k_scale, and v_scale / v_zp are applied to the output. The math
// is exact f32; the TPU route that truncates q and p to one bf16 MXU pass
// is not copied.
//
// With `return_state` (the time-minor self cache reads through this kernel
// and merges its new token outside) the kernel also writes each query's
// online-softmax state: m, the largest live score, and l, the sum of
// exp(s - m) over the live positions. A query with no live position
// (kv_len == 0) gets m = -1e30 (the TPU kernel's NEG_INF), l = 0 and a zero
// output, which weighs exactly 0 when the caller merges it. The TPU
// option `dynamic_grid` (read only the live chunks) is what this kernel
// always does.
//
// Bound on the card: bytes. Each (batch, head) reads d/2 * kv_len bytes of
// packed K and as many of V and does ~4 d kv_len operations per query on
// them: about 8 * group operations per byte, below the ridge for every
// beam width served.
//
// Design (first version): one block per (batch, head), three passes over
// positions [0, kv_len) only, so the padded tail is never read.
//   1. scores: each thread takes 4 consecutive positions at a time, reads
//      one 4-byte word per channel row (a warp reads 128 contiguous bytes
//      of a row), unpacks the nibbles in registers once and uses them for
//      all G queries, writing G x 4 scores to shared memory;
//   2. block max per query, then p = exp(s - max) in place, block sums;
//   3. values: threads split as (channel row, position slice); each
//      unpacks its V words once and sums p * v for all G queries over its
//      slice, and the slices of a row meet by warp shuffles.
// G is a template parameter (1..8), so the per-query states live in
// registers. `layer_idx` and `kv_len` are device scalars read here, so the
// decode loop never waits on the host. One block per (batch, head) leaves
// most SMs idle at small batch; splitting T across blocks comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head_dim
constexpr int THREADS = 256;  // per block; a multiple of every row count
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;      // queries a block serves
constexpr int MAX_SCORES = 49152;  // G * T_pad scores in 192 KB of shared memory

enum Mode { PACKED4 = 0, INT8 = 1, BF16 = 2, F32 = 3 };

// 4 consecutive positions of one channel row (unpacked modes).
template <int MODE>
__device__ __forceinline__ void load4(const void* base, size_t idx,
                                      float out[4]) {
  if (MODE == INT8) {
    const int w = *reinterpret_cast<const int*>(
        reinterpret_cast<const int8_t*>(base) + idx);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (float)((int8_t)(w >> (8 * j)));
  } else if (MODE == BF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + idx);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
    out[0] = __low2float(a);
    out[1] = __high2float(a);
    out[2] = __low2float(b);
    out[3] = __high2float(b);
  } else {
    const float4 w = *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(base) + idx);
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  }
}

// 4 consecutive positions of one packed row: sign-extended low nibbles
// (channel i) and high nibbles (channel i + d/2).
__device__ __forceinline__ void load4_packed(const void* base, size_t idx,
                                             float lo[4], float hi[4]) {
  const int w = *reinterpret_cast<const int*>(
      reinterpret_cast<const int8_t*>(base) + idx);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int8_t byte = (int8_t)(w >> (8 * j));
    lo[j] = (float)((int8_t)(byte << 4) >> 4);
    hi[j] = (float)(byte >> 4);  // arithmetic shift keeps the sign
  }
}

// Block-wide max or sum of each of G values; every thread gets the results.
template <int G>
__device__ __forceinline__ void block_reduce(float (&x)[G],
                                             float (*red)[WARPS],
                                             bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], off);
      x[g] = is_max ? fmaxf(x[g], y) : x[g] + y;
    }
  }
  __syncthreads();  // red is reused across calls
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[g][warp] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x[g] = is_max ? -INFINITY : 0.f;
    for (int w = 0; w < WARPS; ++w)
      x[g] = is_max ? fmaxf(x[g], red[g][w]) : x[g] + red[g][w];
  }
}

template <int MODE, int G>
__global__ void __launch_bounds__(THREADS)
    decode_cross_kernel(const float* __restrict__ q, const void* __restrict__ kt,
                        const void* __restrict__ vt,
                        const int* __restrict__ layer_idx,
                        const int* __restrict__ kv_len_ptr,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int batch, int heads,
                        int t_pad) {
  constexpr int DD = MODE == PACKED4 ? HD / 2 : HD;  // stored rows
  constexpr int SLICES = THREADS / DD;               // pass-3 slices per row
  extern __shared__ float sc[];  // G x t_pad scores, then weights
  __shared__ float qs[G][HD];
  __shared__ float red[G][WARPS];

  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int layer = layer_idx ? *layer_idx : 0;
  const int kv_len = max(0, min(*kv_len_ptr, t_pad));
  const size_t head = (size_t)bi * heads + hi;
  const size_t slab = (((size_t)layer * batch + bi) * heads + hi) * DD * t_pad;
  for (int i = tid; i < G * HD; i += THREADS) qs[i / HD][i % HD] = q[head * G * HD + i];
  __syncthreads();

  // pass 1: scores of positions [0, 4 * groups)
  const int groups = (kv_len + 3) / 4;
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int p4 = tid; p4 < groups; p4 += THREADS) {
    float s[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[g][j] = 0.f;
    for (int i = 0; i < DD; ++i) {
      const size_t idx = slab + (size_t)i * t_pad + 4 * p4;
      if (MODE == PACKED4) {
        float lo[4], hi4[4];
        load4_packed(kt, idx, lo, hi4);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[g][j] = fmaf(qs[g][i], lo[j], fmaf(qs[g][i + HD / 2], hi4[j], s[g][j]));
      } else {
        float x[4];
        load4<MODE>(kt, idx, x);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[g][j] = fmaf(qs[g][i], x[j], s[g][j]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sj = 4 * p4 + j < kv_len ? s[g][j] : -INFINITY;
        sc[g * t_pad + 4 * p4 + j] = sj;
        m[g] = fmaxf(m[g], sj);
      }
  }
  block_reduce<G>(m, red, true);

  // pass 2: weights in place; masked tail positions get exactly 0
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = 0.f;
    for (int t = tid; t < 4 * groups; t += THREADS) {
      const float p = t < kv_len ? __expf(sc[g * t_pad + t] - m[g]) : 0.f;
      sc[g * t_pad + t] = p;
      l[g] += p;
    }
  }
  block_reduce<G>(l, red, false);  // its barrier also publishes sc

  // pass 3: out[g, c] = sum_t p[g, t] v[c, t]
  const int row = tid / SLICES, sl = tid % SLICES;
  float a_lo[G], a_hi[G];
#pragma unroll
  for (int g = 0; g < G; ++g) a_lo[g] = a_hi[g] = 0.f;
  for (int p4 = sl; p4 < groups; p4 += SLICES) {
    const size_t idx = slab + (size_t)row * t_pad + 4 * p4;
    if (MODE == PACKED4) {
      float lo[4], hi4[4];
      load4_packed(vt, idx, lo, hi4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* p = sc + g * t_pad + 4 * p4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a_lo[g] = fmaf(p[j], lo[j], a_lo[g]);
          a_hi[g] = fmaf(p[j], hi4[j], a_hi[g]);
        }
      }
    } else {
      float x[4];
      load4<MODE>(vt, idx, x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* p = sc + g * t_pad + 4 * p4;
#pragma unroll
        for (int j = 0; j < 4; ++j) a_lo[g] = fmaf(p[j], x[j], a_lo[g]);
      }
    }
  }
  // the SLICES threads of a row are consecutive lanes of one warp
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = SLICES / 2; off > 0; off >>= 1) {
      a_lo[g] += __shfl_xor_sync(0xffffffffu, a_lo[g], off);
      a_hi[g] += __shfl_xor_sync(0xffffffffu, a_hi[g], off);
    }
  }
  if (sl == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float inv = 1.f / fmaxf(l[g], 1e-30f);
      float* o = out + (head * G + g) * HD;
      o[row] = a_lo[g] * inv;
      if (MODE == PACKED4) o[row + HD / 2] = a_hi[g] * inv;
    }
  }
  if (m_out != nullptr && tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_out[head * G + g] = m[g] == -INFINITY ? -1e30f : m[g];
      l_out[head * G + g] = l[g];
    }
  }
}

struct Args {
  const float* q;
  const void* kt;
  const void* vt;
  const int* layer_idx;
  const int* kv_len;
  float* out;
  float* m_out;  // NULL unless the state is asked for
  float* l_out;
  int batch, heads, t_pad;
};

template <int MODE, int G>
int launch(const Args& a, cudaStream_t st) {
  const dim3 grid(a.heads, a.batch);
  const size_t smem = (size_t)G * a.t_pad * sizeof(float);
  // with the static arrays, more than 32 KB of scores passes the 48 KB
  // default: opt in once per instantiation, never during a graph capture
  static bool opted_in = false;
  if (smem > 32 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_cross_kernel<MODE, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_SCORES * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  decode_cross_kernel<MODE, G><<<grid, THREADS, smem, st>>>(
      a.q, a.kt, a.vt, a.layer_idx, a.kv_len, a.out, a.m_out, a.l_out,
      a.batch, a.heads, a.t_pad);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_group(const Args& a, int group, cudaStream_t st) {
  switch (group) {
    case 1: return launch<MODE, 1>(a, st);
    case 2: return launch<MODE, 2>(a, st);
    case 3: return launch<MODE, 3>(a, st);
    case 4: return launch<MODE, 4>(a, st);
    case 5: return launch<MODE, 5>(a, st);
    case 6: return launch<MODE, 6>(a, st);
    case 7: return launch<MODE, 7>(a, st);
    case 8: return launch<MODE, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (batch, heads, group, head_dim) f32, pre-scaled. kt, vt: (layers,
// batch, heads, rows, t_pad) with rows = head_dim / 2 for mode 0 (packed
// int4), head_dim for modes 1 (int8), 2 (bf16), 3 (f32). layer_idx: device
// int32 scalar or NULL (then layers = 1); kv_len: device int32 scalar.
// out: (batch, heads, group, head_dim) f32. m_out, l_out: (batch, heads,
// group) f32, both NULL or both given (the online-softmax state). group is
// 1..8 with group * t_pad <= 49152. Returns cudaGetLastError() after the
// launch.
extern "C" int decode_cross_attention(const void* q, const void* kt,
                                      const void* vt, const void* layer_idx,
                                      const void* kv_len, void* out,
                                      void* m_out, void* l_out, int batch,
                                      int heads, int head_dim, int t_pad,
                                      int group, int mode, void* stream) {
  if (head_dim != HD || t_pad <= 0 || t_pad % 4 != 0 || group < 1 ||
      group > MAX_G || group * t_pad > MAX_SCORES || batch <= 0 ||
      batch > 65535 || heads <= 0 || (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)q, kt, vt, (const int*)layer_idx,
               (const int*)kv_len, (float*)out, (float*)m_out, (float*)l_out,
               batch, heads, t_pad};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case PACKED4: return launch_group<PACKED4>(a, group, st);
    case INT8: return launch_group<INT8>(a, group, st);
    case BF16: return launch_group<BF16>(a, group, st);
    case F32: return launch_group<F32>(a, group, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

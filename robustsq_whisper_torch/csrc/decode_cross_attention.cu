// One-query cross attention over quantized encoder K/V (the decode loop).
//
// Replaces the TPU kernels `_kernel` / `_kernel_grouped` with group 1 (JAX
// package, ops/decode_attention.py, entry `decode_cross_attention`):
// softmax(q . K) V for one query per (batch, head) against K/V stored
// transposed as (layers, batch, heads, d[/2], T_pad), the layer's slab
// picked by `layer_idx` and positions >= `kv_len` masked. Storage is packed
// int4 (two channels a byte: channel i in the low nibble, i + d/2 in the
// high one), int8, bf16 or f32. The caller folds every scale: q arrives
// pre-scaled by d^-0.5 * k_scale, and v_scale / v_zp are applied to the
// output. The math is the exact f32 math of `_kernel`; the TPU route that
// duplicates the query to run truncated bf16 MXU dots is not copied.
//
// Bound on the card: bytes. Each (batch, head) reads d/2 * kv_len bytes of
// packed K and as many of V and does ~4 d kv_len operations on them, about
// 8 operations per byte, far below the ridge.
//
// Design (first version): one block per (batch, head), three passes over
// positions [0, kv_len) only, so the padded tail is never read.
//   1. scores: each thread takes 4 consecutive positions at a time, reads
//      one 4-byte word per channel row (a warp reads 128 contiguous bytes
//      of a row), unpacks the nibbles in registers and writes the 4 scores
//      to shared memory;
//   2. block max, then p = exp(s - max) in place, block sum;
//   3. values: threads split as (channel row, position slice), each sums
//      p * v over its slice, and the slices of a row meet by warp shuffles.
// `layer_idx` and `kv_len` are device scalars read here, so the decode
// loop never waits on the host. One block per (batch, head) leaves most SMs
// idle at small batch; splitting T across blocks comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head_dim
constexpr int THREADS = 256;  // per block; a multiple of every row count
constexpr int MAX_T = 12288;  // scores live in 48 KB of shared memory

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

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is reused across calls
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = is_max ? -INFINITY : 0.f;
  for (int w = 0; w < THREADS / 32; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    decode_cross_kernel(const float* __restrict__ q, const void* __restrict__ kt,
                        const void* __restrict__ vt,
                        const int* __restrict__ layer_idx,
                        const int* __restrict__ kv_len_ptr,
                        float* __restrict__ out, int batch, int heads,
                        int t_pad) {
  constexpr int DD = MODE == PACKED4 ? HD / 2 : HD;  // stored rows
  constexpr int SLICES = THREADS / DD;               // pass-3 slices per row
  extern __shared__ float sc[];                      // scores, then weights
  __shared__ float qs[HD];
  __shared__ float red[THREADS / 32];

  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int layer = layer_idx ? *layer_idx : 0;
  const int kv_len = max(0, min(*kv_len_ptr, t_pad));
  const size_t head = (size_t)bi * heads + hi;
  const size_t slab = (((size_t)layer * batch + bi) * heads + hi) * DD * t_pad;
  if (tid < HD) qs[tid] = q[head * HD + tid];
  __syncthreads();

  // pass 1: scores of positions [0, 4 * groups)
  const int groups = (kv_len + 3) / 4;
  float m = -INFINITY;
  for (int g = tid; g < groups; g += THREADS) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < DD; ++i) {
      const size_t idx = slab + (size_t)i * t_pad + 4 * g;
      if (MODE == PACKED4) {
        float lo[4], hi4[4];
        load4_packed(kt, idx, lo, hi4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[j] = fmaf(qs[i], lo[j], fmaf(qs[i + HD / 2], hi4[j], s[j]));
      } else {
        float x[4];
        load4<MODE>(kt, idx, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = fmaf(qs[i], x[j], s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sj = 4 * g + j < kv_len ? s[j] : -INFINITY;
      sc[4 * g + j] = sj;
      m = fmaxf(m, sj);
    }
  }
  m = block_reduce(m, red, true);

  // pass 2: weights in place; masked tail positions get exactly 0
  float l = 0.f;
  for (int t = tid; t < 4 * groups; t += THREADS) {
    const float p = t < kv_len ? __expf(sc[t] - m) : 0.f;
    sc[t] = p;
    l += p;
  }
  l = block_reduce(l, red, false);  // its barrier also publishes sc

  // pass 3: out[c] = sum_t p[t] v[c, t]
  const int row = tid / SLICES, sl = tid % SLICES;
  float a_lo = 0.f, a_hi = 0.f;
  for (int g = sl; g < groups; g += SLICES) {
    const size_t idx = slab + (size_t)row * t_pad + 4 * g;
    const float* p = sc + 4 * g;
    if (MODE == PACKED4) {
      float lo[4], hi4[4];
      load4_packed(vt, idx, lo, hi4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_lo = fmaf(p[j], lo[j], a_lo);
        a_hi = fmaf(p[j], hi4[j], a_hi);
      }
    } else {
      float x[4];
      load4<MODE>(vt, idx, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) a_lo = fmaf(p[j], x[j], a_lo);
    }
  }
  // the SLICES threads of a row are consecutive lanes of one warp
#pragma unroll
  for (int off = SLICES / 2; off > 0; off >>= 1) {
    a_lo += __shfl_xor_sync(0xffffffffu, a_lo, off);
    a_hi += __shfl_xor_sync(0xffffffffu, a_hi, off);
  }
  if (sl == 0) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    out[head * HD + row] = a_lo * inv;
    if (MODE == PACKED4) out[head * HD + row + HD / 2] = a_hi * inv;
  }
}

}  // namespace

// q: (batch, heads, head_dim) f32, pre-scaled. kt, vt: (layers, batch,
// heads, rows, t_pad) with rows = head_dim / 2 for mode 0 (packed int4),
// head_dim for modes 1 (int8), 2 (bf16), 3 (f32). layer_idx: device int32
// scalar or NULL (then layers = 1); kv_len: device int32 scalar. out:
// (batch, heads, head_dim) f32. Returns cudaGetLastError() after launch.
extern "C" int decode_cross_attention(const void* q, const void* kt,
                                      const void* vt, const void* layer_idx,
                                      const void* kv_len, void* out, int batch,
                                      int heads, int head_dim, int t_pad,
                                      int mode, void* stream) {
  if (head_dim != HD || t_pad <= 0 || t_pad % 4 != 0 || t_pad > MAX_T ||
      batch <= 0 || batch > 65535 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(heads, batch);
  const size_t smem = (size_t)t_pad * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const int* li = (const int*)layer_idx;
  const int* kl = (const int*)kv_len;
  const float* qf = (const float*)q;
  float* o = (float*)out;
  switch (mode) {
    case PACKED4:
      decode_cross_kernel<PACKED4><<<grid, THREADS, smem, st>>>(
          qf, kt, vt, li, kl, o, batch, heads, t_pad);
      break;
    case INT8:
      decode_cross_kernel<INT8><<<grid, THREADS, smem, st>>>(
          qf, kt, vt, li, kl, o, batch, heads, t_pad);
      break;
    case BF16:
      decode_cross_kernel<BF16><<<grid, THREADS, smem, st>>>(
          qf, kt, vt, li, kl, o, batch, heads, t_pad);
      break;
    case F32:
      decode_cross_kernel<F32><<<grid, THREADS, smem, st>>>(
          qf, kt, vt, li, kl, o, batch, heads, t_pad);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

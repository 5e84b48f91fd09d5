// Encoder self-attention in the transposed (b*h, head_dim, T) layout.
//
// Replaces the TPU kernel `_attn_kernel_tmaj` (JAX package,
// ops/flash_attention.py, entry `flash_attention_tmaj`): unmasked
// softmax(Q K^T / sqrt(d)) V with an f32 online softmax, ragged T masked
// inside the kernel, time the contiguous axis of every operand.
//
// Bound on the card: operations. At Whisper-medium (T = 1516, d = 64) one
// (batch, head) pair does 4 * T^2 * d = 0.59 GFLOP against 0.78 MB of
// bf16 operands, far above the H100's ~295 FLOP/byte ridge.
//
// bf16 (the serving dtype) runs on the tensor cores with mma.sync
// m16n8k16 (f32 accumulation), FlashAttention-2 style: one block of 4 warps
// per (b*h, 64-query tile), 16 queries a warp, 64-key K and V tiles staged
// in shared memory. Shared memory keeps the global layout, (channel, time)
// with time contiguous, so a tile loads with coalesced reads along T and
// no transpose: `ldmatrix.trans` turns the Q and K tiles into the A and B
// operands of S = Q K^T, and a plain `ldmatrix` turns the V tile into the
// B operand of O = P V (P is the S accumulator rounded to bf16, as the
// TPU's default-precision dot rounds it). Scores, running max, denominator
// and O stay in registers in f32. Keys at or past T score -inf AND load as
// 0 into the V tile: a zero weight times an uninitialised value could
// still poison the sum (the TPU kernel zeroes its V tail for the same
// reason). The next K/V tiles load into registers while the current ones
// are multiplied; TMA, a shared-memory ring and wgmma are the later
// speed-ups.
//
// f32 inputs (the tests' exact path) run a plain SIMT kernel: one thread
// per query, q and its accumulator in registers, K/V tiles in shared
// memory transposed to (key, channel) so every thread reads the same row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;  // head_dim (every Whisper size)
constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16: tensor cores ----

constexpr int TILE = 64;     // queries per block (4 warps x 16) and keys
                             // per K/V tile
constexpr int LD = TILE + 8; // smem row stride in elements (144 B): rows
                             // land on distinct banks for ldmatrix

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One (HD, 64) tile of a (HD, t_len) slab, held in registers between its
// global load and its shared-memory store, so the next K/V tile's loads
// are in flight while the current one is multiplied. W is the load word:
// 4 bf16 (8 B) when t_len % 4 == 0, which keeps every word aligned and
// either wholly inside [0, t_len) or wholly past it; else 1 bf16. Words
// past t_len load as 0. Consecutive threads take consecutive words of a
// channel row: loads coalesce along T.
template <typename W>
struct Tile {
  static constexpr int VEC = sizeof(W) / 2;       // bf16 per word
  static constexpr int ROW = TILE / VEC;            // words per channel row
  static constexpr int PER = HD * ROW / 128;      // words per thread
  W r[PER];

  __device__ __forceinline__ static int chan(int i) {
    return (threadIdx.x + 128 * i) / ROW;
  }
  __device__ __forceinline__ static int col(int i) {
    return (threadIdx.x + 128 * i) % ROW * VEC;
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ src,
                                       int t0, int t_len) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = t0 + col(i);
      r[i] = t < t_len
                 ? *reinterpret_cast<const W*>(src + (size_t)chan(i) * t_len + t)
                 : W{};
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      *reinterpret_cast<W*>(dst + chan(i) * LD + col(i)) = r[i];
  }
  // shared (HD, 64) tile -> global times [t0, t_len)
  __device__ __forceinline__ static void write(__nv_bfloat16* __restrict__ dst,
                                               const __nv_bfloat16* src,
                                               int t0, int t_len) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = t0 + col(i);
      if (t < t_len)
        *reinterpret_cast<W*>(dst + (size_t)chan(i) * t_len + t) =
            *reinterpret_cast<const W*>(src + chan(i) * LD + col(i));
    }
  }
};

template <typename W>
__global__ void __launch_bounds__(128)
    flash_tmaj_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int t_len,
                          float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[HD * LD];  // Q, later O
  __shared__ __align__(16) __nv_bfloat16 ks[HD * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[HD * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * HD * t_len;
  // ldmatrix addressing: lane L feeds row (L & 7) of 8x8 matrix (L >> 3)
  const int li = lane & 7, lm = lane >> 3;

  Tile<W> kt, vt;
  kt.load(q + base, q0, t_len);  // the Q tile goes through kt first
  kt.store(qs);
  kt.load(k + base, 0, t_len);
  vt.load(v + base, 0, t_len);
  __syncthreads();
  // A operand of S = Q K^T: rows = the warp's 16 queries, cols = channels.
  // Matrix lm covers queries +8*(lm & 1), channels +8*(lm >> 1).
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    ldsm_x4_t(qa[kc], smem_addr(&qs[(16 * kc + li + 8 * (lm >> 1)) * LD +
                                    16 * warp + 8 * (lm & 1)]));

  float acc[HD / 8][4];  // O: rows (g, g + 8), channels 8n + 2(lane % 4)
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial sums

  for (int k0 = 0; k0 < t_len; k0 += TILE) {
    __syncthreads();  // the previous K/V tiles are consumed
    kt.store(ks);
    vt.store(vs);
    __syncthreads();
    if (k0 + TILE < t_len) {  // the next tiles load during this one's math
      kt.load(k + base, k0 + TILE, t_len);
      vt.load(v + base, k0 + TILE, t_len);
    }

    // S = Q K^T: 16 queries x 64 keys a warp, as 8 n-tiles of 8 keys
    float s[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < TILE / 8; n += 2) {
        // matrix lm: channels +8*(lm & 1), keys +8*(lm >> 1)
        uint32_t b[4];
        ldsm_x4_t(b, smem_addr(&ks[(16 * kc + li + 8 * (lm & 1)) * LD + 8 * n +
                                   8 * (lm >> 1)]));
        mma16816(s[n], qa[kc], b[0], b[1]);
        mma16816(s[n + 1], qa[kc], b[2], b[3]);
      }
    }

    // online softmax in log2 units; keys >= t_len (last tile) score -inf
    const bool ragged = k0 + TILE > t_len;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
        s[n][e] = ragged && key >= t_len ? -INFINITY : s[n][e] * scale_log2;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    // a row's 64 scores sit in the 4 lanes of a quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // every tile holds a key < t_len, so the new max is finite and the
    // first tile's alpha is exp2(-inf) = 0
    const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }
    // P as the A operand of O = P V: key slice kc is n-tiles 2kc, 2kc + 1
    uint32_t pa[TILE / 16][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m_lo), p1 = exp2f(s[n][1] - m_lo);
      const float p2 = exp2f(s[n][2] - m_hi), p3 = exp2f(s[n][3] - m_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V tile is (channel, key) = the col-major B operand
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        // matrix lm: channels +8*(lm >> 1), keys +8*(lm & 1)
        uint32_t b[4];
        ldsm_x4(b, smem_addr(&vs[(8 * n + li + 8 * (lm >> 1)) * LD + 16 * kc +
                                 8 * (lm & 1)]));
        mma16816(acc[n], pa[kc], b[0], b[1]);
        mma16816(acc[n + 1], pa[kc], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  // stage O as (channel, query) in the Q buffer (each warp owns its own
  // query columns there), then store along T
  const int g = 16 * warp + (lane >> 2);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * (lane & 3);
    qs[c * LD + g] = __float2bfloat16(acc[n][0] * inv_lo);
    qs[(c + 1) * LD + g] = __float2bfloat16(acc[n][1] * inv_lo);
    qs[c * LD + g + 8] = __float2bfloat16(acc[n][2] * inv_hi);
    qs[(c + 1) * LD + g + 8] = __float2bfloat16(acc[n][3] * inv_hi);
  }
  __syncthreads();
  Tile<W>::write(o + base, qs, q0, t_len);
}

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
    const dim3 grid((t_len + TILE - 1) / TILE, bh);
    const auto* qb = (const __nv_bfloat16*)q;
    const auto* kb = (const __nv_bfloat16*)k;
    const auto* vb = (const __nv_bfloat16*)v;
    auto* ob = (__nv_bfloat16*)o;
    if (t_len % 4 == 0)  // 8-byte words stay aligned (16-byte base pointers)
      flash_tmaj_mma_kernel<uint2><<<grid, 128, 0, st>>>(qb, kb, vb, ob, t_len,
                                                         scale_log2);
    else
      flash_tmaj_mma_kernel<unsigned short><<<grid, 128, 0, st>>>(
          qb, kb, vb, ob, t_len, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

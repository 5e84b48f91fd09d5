// Shared pieces of the row-major flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): the tensor-core helpers
// (ldmatrix, mma.sync m16n8k16 bf16 -> f32) and the tile that moves 64 rows
// of a (batch, T, heads, 64) tensor between device and shared memory.
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

constexpr int HD = 64;        // head_dim (every Whisper size)
constexpr int TILE = 64;      // rows per tile: 4 warps x 16
constexpr int LD = HD + 8;    // shared row stride in bf16 (144 B): the 8
                              // rows of an ldmatrix land on distinct banks
constexpr float LOG2E = 1.4426950408889634f;

// Additive f32 mask strides in elements, broadcast as (b, h, q, kv); zero
// strides broadcast an axis.
struct MaskStrides {
  int b, h, q, k;
};

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

// Fragment addressing shared by every product below. Lane L feeds row
// (L & 7) of 8x8 matrix (L >> 3) of an ldmatrix.x4; an accumulator c of
// m16n8 holds rows g and g + 8 (g = lane >> 2), columns 2 (lane & 3) + {0, 1}.
//
// A operand, 16 rows x 16 k, from a shared (row, k) tile: rows r0 + 0..15,
// k columns k0 + 0..15.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int r0, int k0, int lane) {
  const int li = lane & 7, lm = lane >> 3;
  ldsm_x4(a, smem_addr(&s[(r0 + li + 8 * (lm & 1)) * LD + k0 + 8 * (lm >> 1)]));
}

// B operands of two n-tiles (n0 .. n0 + 15) for a product over k, from a
// shared (n, k) tile (rows are the product's columns: X Y^T with Y stored
// row-major). b[0], b[1] serve n-tile n0, b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const __nv_bfloat16* s,
                                          int n0, int k0, int lane) {
  const int li = lane & 7, lm = lane >> 3;
  ldsm_x4(b, smem_addr(&s[(n0 + li + 8 * (lm >> 1)) * LD + k0 + 8 * (lm & 1)]));
}

// The same from a shared (k, n) tile (X Y with Y stored row-major): the
// transposing ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const __nv_bfloat16* s,
                                          int k0, int n0, int lane) {
  const int li = lane & 7, lm = lane >> 3;
  ldsm_x4_t(b, smem_addr(&s[(k0 + li + 8 * (lm & 1)) * LD + n0 + 8 * (lm >> 1)]));
}

// acc (16 x 64) += A (16 x 64, four k-slices in registers) * Y (64 x 64)
// with Y a shared (k, n) tile.
__device__ __forceinline__ void mma_rows_kn(float acc[8][4], const uint32_t a[4][4],
                                            const __nv_bfloat16* s, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      load_b_kn(b, s, 16 * kc, 8 * n, lane);
      mma16816(acc[n], a[kc], b[0], b[1]);
      mma16816(acc[n + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc (16 x 64) = A (16 x 64) * Y^T with Y a shared (n, k) tile of 64 rows.
__device__ __forceinline__ void mma_rows_nk(float acc[8][4], const uint32_t a[4][4],
                                            const __nv_bfloat16* s, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      load_b_nk(b, s, 8 * n, 16 * kc, lane);
      mma16816(acc[n], a[kc], b[0], b[1]);
      mma16816(acc[n + 1], a[kc], b[2], b[3]);
    }
  }
}

// An accumulator (16 x 64, f32) as the A operand of a product over its
// columns, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4][4], const float c[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n / 2][(n & 1) * 2 + 0] = pack_bf16(c[n][0], c[n][1]);
    a[n / 2][(n & 1) * 2 + 1] = pack_bf16(c[n][2], c[n][3]);
  }
}

// A warp's accumulator rows (16 x 64) into its rows of a shared tile.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s, const float c[8][4],
                                           int r0, int lane, float scale_lo,
                                           float scale_hi) {
  const int g = r0 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(&s[g * LD + col]) =
        __floats2bfloat162_rn(c[n][0] * scale_lo, c[n][1] * scale_lo);
    *reinterpret_cast<__nv_bfloat162*>(&s[(g + 8) * LD + col]) =
        __floats2bfloat162_rn(c[n][2] * scale_hi, c[n][3] * scale_hi);
  }
}

// 64 rows x 64 bf16 of one head, held in registers between the global load
// and the shared store so the next tile's loads overlap the current math.
// 16-byte words; 8 consecutive threads read one 128-byte row. Rows at or
// past n_rows load as zero (ragged tails never hold stale values).
struct RowTile {
  uint4 r[4];

  __device__ __forceinline__ static int row(int i) { return (threadIdx.x + 128 * i) >> 3; }
  __device__ __forceinline__ static int col(int i) { return ((threadIdx.x + 128 * i) & 7) * 8; }

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ head,
                                       size_t stride, int r0, int n_rows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + row(i);
      r[i] = t < n_rows
                 ? *reinterpret_cast<const uint4*>(head + (size_t)t * stride + col(i))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* s) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(&s[row(i) * LD + col(i)]) = r[i];
  }
  // shared tile -> global rows [r0, n_rows)
  __device__ __forceinline__ static void write(__nv_bfloat16* __restrict__ head,
                                               size_t stride, const __nv_bfloat16* s,
                                               int r0, int n_rows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + row(i);
      if (t < n_rows)
        *reinterpret_cast<uint4*>(head + (size_t)t * stride + col(i)) =
            *reinterpret_cast<const uint4*>(&s[row(i) * LD + col(i)]);
    }
  }
};

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

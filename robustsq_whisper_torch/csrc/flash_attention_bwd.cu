// Row-major flash-attention backward: dQ, and dK with dV.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (JAX
// package, ops/flash_attention.py, tile math `_recompute_p_ds`, wrapper
// `_bwd_impl`). Both recompute the probabilities tile by tile from the
// forward's log-sum-exp, so the (q, kv) score matrix never reaches device
// memory:
//
//   P  = exp(Q K^T / sqrt(d) + mask - lse)      (0 on ragged rows/keys)
//   dP = dO V^T,  dS = P (dP - delta) / sqrt(d), delta = rowsum(dO * O)
//   dQ = dS K,    dV = P^T dO,    dK = dS^T Q
//
// delta comes from the caller (plain PyTorch, as it is plain XLA in JAX).
// Two kernels, as on the TPU, so no atomics are needed and the result is
// deterministic: `flash_attention_bwd_dq` runs one block per (64-query tile,
// b * h) over the key tiles; `flash_attention_bwd_dkv` one block per
// (64-key tile, b * h) over the query tiles. Rows of lse and delta past
// q_len are taken as 0 and their P as 0, and Q / dO rows past q_len load as
// 0, so the zero-weighted products of a ragged tail stay finite (the TPU
// kernels sanitise those rows for the same reason).
//
// Bound on the card: operations. At the Whisper-medium training shape
// (b * h = 128, T = 1516, d = 64) dQ does 6 * bh * T^2 * d = 113 GFLOP and
// dK/dV 8 * bh * T^2 * d = 151 GFLOP.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulation;
// flash_common.cuh), with P and dS rounded to bf16 before their products,
// as the forward rounds P. Every product keeps one operand in registers
// (the block's own 16 rows a warp) and streams the other through shared
// memory: the dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T directly,
// so P^T and dS^T are already in the A-operand layout of dV and dK. f32
// inputs (the tests' exact path) run SIMT kernels: one thread per query
// (dQ) or per key (dK/dV).

#include "flash_common.cuh"

using namespace flash;

namespace {

template <bool MASK>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ dq, int heads, int q_len,
                            int kv_len, MaskStrides ms, float scale,
                            float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[TILE * LD];  // Q, later dQ
  __shared__ __align__(16) __nv_bfloat16 dos[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TILE;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const size_t stride = (size_t)heads * HD;
  const size_t q_head = (size_t)bi * q_len * stride + hi * HD;
  const __nv_bfloat16* kh = k + (size_t)bi * kv_len * stride + hi * HD;
  const __nv_bfloat16* vh = v + (size_t)bi * kv_len * stride + hi * HD;
  const size_t m_off = (size_t)bi * ms.b + (size_t)hi * ms.h;

  RowTile kt, vt;
  kt.load(q + q_head, stride, q0, q_len);
  kt.store(qs);
  kt.load(dout + q_head, stride, q0, q_len);
  kt.store(dos);
  kt.load(kh, stride, 0, kv_len);
  vt.load(vh, stride, 0, kv_len);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    load_a(qa[kc], qs, 16 * warp, 16 * kc, lane);
    load_a(da[kc], dos, 16 * warp, 16 * kc, lane);
  }
  const int r_lo = q0 + 16 * warp + (lane >> 2), r_hi = r_lo + 8;
  const float lse_lo = r_lo < q_len ? lse[(size_t)bh * q_len + r_lo] * LOG2E : 0.f;
  const float lse_hi = r_hi < q_len ? lse[(size_t)bh * q_len + r_hi] * LOG2E : 0.f;
  const float dl_lo = r_lo < q_len ? delta[(size_t)bh * q_len + r_lo] : 0.f;
  const float dl_hi = r_hi < q_len ? delta[(size_t)bh * q_len + r_hi] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += TILE) {
    __syncthreads();
    kt.store(ks);
    vt.store(vs);
    __syncthreads();
    if (k0 + TILE < kv_len) {
      kt.load(kh, stride, k0 + TILE, kv_len);
      vt.load(vh, stride, k0 + TILE, kv_len);
    }
    float s[8][4], dp[8][4];
    mma_rows_nk(s, qa, ks, lane);   // S = Q K^T
    mma_rows_nk(dp, da, vs, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        float p = 0.f;
        if (key < kv_len && row < q_len) {
          const float x = s[n][e] * scale_log2 +
                          mask_log2<MASK>(mask, m_off, ms, row, key) -
                          (e < 2 ? lse_lo : lse_hi);
          p = exp2f(x);
        }
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl_lo : dl_hi)) * scale;  // dS
      }
    }
    uint32_t dsa[4][4];
    acc_to_a(dsa, s);
    mma_rows_kn(acc, dsa, ks, lane);  // dQ += dS K
  }
  stage_rows(qs, acc, 16 * warp, lane, 1.f, 1.f);  // qs is not read again
  __syncthreads();
  RowTile::write(dq + q_head, stride, qs, q0, q_len);
}

template <bool MASK>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ mask,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int heads, int q_len,
                             int kv_len, MaskStrides ms, float scale,
                             float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[TILE * LD];   // K, Q tiles, dK
  __shared__ __align__(16) __nv_bfloat16 dos[TILE * LD];  // V, dO tiles, dV
  __shared__ float ls[TILE], dl[TILE];  // lse (log2 units) and delta rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * TILE;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const size_t stride = (size_t)heads * HD;
  const size_t k_head = (size_t)bi * kv_len * stride + hi * HD;
  const __nv_bfloat16* qh = q + (size_t)bi * q_len * stride + hi * HD;
  const __nv_bfloat16* dh = dout + (size_t)bi * q_len * stride + hi * HD;
  const size_t m_off = (size_t)bi * ms.b + (size_t)hi * ms.h;

  RowTile qt, dt;
  qt.load(k + k_head, stride, k0, kv_len);
  qt.store(qs);
  qt.load(v + k_head, stride, k0, kv_len);
  qt.store(dos);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    load_a(ka[kc], qs, 16 * warp, 16 * kc, lane);
    load_a(va[kc], dos, 16 * warp, 16 * kc, lane);
  }
  qt.load(qh, stride, 0, q_len);
  dt.load(dh, stride, 0, q_len);
  const int c_lo = k0 + 16 * warp + (lane >> 2), c_hi = c_lo + 8;  // keys

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = dva[n][0] = dva[n][1] =
        dva[n][2] = dva[n][3] = 0.f;

  for (int q0 = 0; q0 < q_len; q0 += TILE) {
    __syncthreads();  // K/V fragments taken, or the previous tiles consumed
    qt.store(qs);
    dt.store(dos);
    if (threadIdx.x < TILE) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < q_len ? lse[(size_t)bh * q_len + r] * LOG2E : 0.f;
    } else {
      const int r = q0 + threadIdx.x - TILE;
      dl[threadIdx.x - TILE] = r < q_len ? delta[(size_t)bh * q_len + r] : 0.f;
    }
    __syncthreads();
    if (q0 + TILE < q_len) {
      qt.load(qh, stride, q0 + TILE, q_len);
      dt.load(dh, stride, q0 + TILE, q_len);
    }
    float st[8][4], dpt[8][4];  // rows: this warp's 16 keys; cols: 64 queries
    mma_rows_nk(st, ka, qs, lane);    // S^T = K Q^T
    mma_rows_nk(dpt, va, dos, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * (lane & 3) + (e & 1);  // query in the tile
        const int query = q0 + j;
        const int key = e < 2 ? c_lo : c_hi;
        float p = 0.f;
        if (query < q_len && key < kv_len)
          p = exp2f(st[n][e] * scale_log2 +
                    mask_log2<MASK>(mask, m_off, ms, query, key) - ls[j]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dl[j]) * scale;  // dS^T
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a(pa, st);
    acc_to_a(dsa, dpt);
    mma_rows_kn(dva, pa, dos, lane);   // dV += P^T dO
    mma_rows_kn(dka, dsa, qs, lane);   // dK += dS^T Q
  }
  __syncthreads();  // every warp is done with the Q / dO tiles
  stage_rows(qs, dka, 16 * warp, lane, 1.f, 1.f);
  stage_rows(dos, dva, 16 * warp, lane, 1.f, 1.f);
  __syncthreads();
  RowTile::write(dk + k_head, stride, qs, k0, kv_len);
  RowTile::write(dv + k_head, stride, dos, k0, kv_len);
}

// ---- f32: exact SIMT ----

constexpr int BT = 128;  // queries (dQ) or keys (dK/dV) per block = threads
constexpr int BS = 32;   // rows per streamed shared-memory tile

template <bool MASK>
__global__ void __launch_bounds__(BT)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ mask, float* __restrict__ dq,
                            int heads, int q_len, int kv_len, MaskStrides ms,
                            float scale, float scale_log2) {
  __shared__ __align__(16) float ks[BS * KS];
  __shared__ __align__(16) float vs[BS * KS];
  const int qi = blockIdx.x * BT + threadIdx.x;
  const bool live = qi < q_len;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const size_t stride = (size_t)heads * HD;
  const float* kh = k + (size_t)bi * kv_len * stride + hi * HD;
  const float* vh = v + (size_t)bi * kv_len * stride + hi * HD;
  const size_t q_row = ((size_t)bi * q_len + (live ? qi : 0)) * stride + hi * HD;
  const size_t m_off = (size_t)bi * ms.b + (size_t)hi * ms.h;

  float qr[HD], dr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = live ? q[q_row + c] * scale_log2 : 0.f;
    dr[c] = live ? dout[q_row + c] : 0.f;
    acc[c] = 0.f;
  }
  const float l2 = live ? lse[(size_t)bh * q_len + qi] * LOG2E : 0.f;
  const float de = live ? delta[(size_t)bh * q_len + qi] : 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += BS) {
    __syncthreads();
    load_rows_f32(ks, kh, stride, k0, BS, kv_len);
    load_rows_f32(vs, vh, stride, k0, BS, kv_len);
    __syncthreads();
    const int nk = min(BS, kv_len - k0);
    for (int j = 0; j < nk; ++j) {
      const float x = dot64(qr, ks + j * KS) +
                      (live ? mask_log2<MASK>(mask, m_off, ms, qi, k0 + j) : 0.f);
      const float p = live ? exp2f(x - l2) : 0.f;
      const float ds = p * (dot64(dr, vs + j * KS) - de) * scale;
      axpy64(acc, ds, ks + j * KS);
    }
  }
  if (live) {
    float* out = dq + q_row;
#pragma unroll
    for (int c = 0; c < HD; ++c) out[c] = acc[c];
  }
}

template <bool MASK>
__global__ void __launch_bounds__(BT)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ mask, float* __restrict__ dk,
                             float* __restrict__ dv, int heads, int q_len, int kv_len,
                             MaskStrides ms, float scale, float scale_log2) {
  __shared__ __align__(16) float qs[BS * KS];
  __shared__ __align__(16) float dos[BS * KS];
  __shared__ float ls[BS], dl[BS];
  const int ki = blockIdx.x * BT + threadIdx.x;
  const bool live = ki < kv_len;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const size_t stride = (size_t)heads * HD;
  const float* qh = q + (size_t)bi * q_len * stride + hi * HD;
  const float* dh = dout + (size_t)bi * q_len * stride + hi * HD;
  const size_t k_row = ((size_t)bi * kv_len + (live ? ki : 0)) * stride + hi * HD;
  const size_t m_off = (size_t)bi * ms.b + (size_t)hi * ms.h;

  float kr[HD], vr[HD], dka[HD], dva[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    kr[c] = live ? k[k_row + c] * scale_log2 : 0.f;
    vr[c] = live ? v[k_row + c] : 0.f;
    dka[c] = dva[c] = 0.f;
  }
  for (int q0 = 0; q0 < q_len; q0 += BS) {
    __syncthreads();
    load_rows_f32(qs, qh, stride, q0, BS, q_len);
    load_rows_f32(dos, dh, stride, q0, BS, q_len);
    if (threadIdx.x < BS) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < q_len ? lse[(size_t)bh * q_len + r] * LOG2E : 0.f;
      dl[threadIdx.x] = r < q_len ? delta[(size_t)bh * q_len + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(BS, q_len - q0);
    for (int j = 0; j < nq; ++j) {
      const float x = dot64(kr, qs + j * KS) +
                      (live ? mask_log2<MASK>(mask, m_off, ms, q0 + j, ki) : 0.f);
      const float p = live ? exp2f(x - ls[j]) : 0.f;
      const float ds = p * (dot64(vr, dos + j * KS) - dl[j]) * scale;
      axpy64(dva, p, dos + j * KS);
      axpy64(dka, ds, qs + j * KS);
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[k_row + c] = dka[c];
      dv[k_row + c] = dva[c];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *mask;
  int bh, heads, q_len, kv_len;
  MaskStrides ms;
  float scale, scale_log2;
};

template <bool MASK>
void launch_dq(const Args& a, void* dq, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((a.q_len + BT - 1) / BT, a.bh);
    flash_bwd_dq_f32_kernel<MASK><<<grid, BT, 0, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, a.mask, (float*)dq, a.heads,
        a.q_len, a.kv_len, a.ms, a.scale, a.scale_log2);
  } else {
    const dim3 grid((a.q_len + TILE - 1) / TILE, a.bh);
    flash_bwd_dq_mma_kernel<MASK><<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const __nv_bfloat16*)a.dout, a.lse, a.delta,
        a.mask, (__nv_bfloat16*)dq, a.heads, a.q_len, a.kv_len, a.ms, a.scale,
        a.scale_log2);
  }
}

template <bool MASK>
void launch_dkv(const Args& a, void* dk, void* dv, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((a.kv_len + BT - 1) / BT, a.bh);
    flash_bwd_dkv_f32_kernel<MASK><<<grid, BT, 0, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, a.mask, (float*)dk, (float*)dv,
        a.heads, a.q_len, a.kv_len, a.ms, a.scale, a.scale_log2);
  } else {
    const dim3 grid((a.kv_len + TILE - 1) / TILE, a.bh);
    flash_bwd_dkv_mma_kernel<MASK><<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const __nv_bfloat16*)a.dout, a.lse, a.delta,
        a.mask, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a.heads, a.q_len,
        a.kv_len, a.ms, a.scale, a.scale_log2);
  }
}

bool make_args(Args& a, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* mask, int batch, int heads, int q_len, int kv_len,
               int head_dim, int smb, int smh, int smq, int smk, int dtype) {
  a = Args{q, k, v, dout, (const float*)lse, (const float*)delta,
           (const float*)mask, batch * heads, heads, q_len, kv_len,
           MaskStrides{smb, smh, smq, smk}, 0.f, 0.f};
  a.scale = 1.f / sqrtf((float)head_dim);
  a.scale_log2 = a.scale * LOG2E;
  return head_dim == HD && q_len > 0 && kv_len > 0 && a.bh > 0 && a.bh <= 65535 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// Shapes as for flash_attention (flash_attention.cu): q, dout, dq (batch,
// q_len, heads, 64); k, v, dk, dv (batch, kv_len, heads, 64); lse and delta
// f32 (batch, heads, q_len); mask null or f32 through its strides. Each
// returns cudaGetLastError() after its launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* mask, void* dq,
                                      int batch, int heads, int q_len, int kv_len,
                                      int head_dim, int smb, int smh, int smq,
                                      int smk, int dtype, void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, mask, batch, heads, q_len, kv_len,
                 head_dim, smb, smh, smq, smk, dtype))
    return (int)cudaErrorInvalidValue;
  if (mask)
    launch_dq<true>(a, dq, dtype, (cudaStream_t)stream);
  else
    launch_dq<false>(a, dq, dtype, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* mask, void* dk,
                                       void* dv, int batch, int heads, int q_len,
                                       int kv_len, int head_dim, int smb, int smh,
                                       int smq, int smk, int dtype, void* stream) {
  Args a;
  if (!make_args(a, q, k, v, dout, lse, delta, mask, batch, heads, q_len, kv_len,
                 head_dim, smb, smh, smq, smk, dtype))
    return (int)cudaErrorInvalidValue;
  if (mask)
    launch_dkv<true>(a, dk, dv, dtype, (cudaStream_t)stream);
  else
    launch_dkv<false>(a, dk, dv, dtype, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

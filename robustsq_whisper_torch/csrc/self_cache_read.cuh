// The one-query read of the flat self cache, shared by the two self-cache
// kernels: decode_self_attention.cu (dense and int8 cache, a normalised
// output with the new token merged last) and settled_self_attention.cu
// (the unnormalised online-softmax state of the settled prefix, read
// through a per-row indirection).
//
// The cache is (layers, rows_phys, T_pad, n_state), heads concatenated
// along n_state, head_dim 64: position t of head h of a row is 64
// contiguous values, n_state values after position t - 1. Storage is f32,
// bf16 or int8; the int8 form has one bf16 (layers, rows_phys, T_pad, 128)
// scale leaf, K's scale of head h in lane h and V's in lane heads + h. K's
// scale multiplies the score after the dot, V's the softmax weight before
// the V sum, while the normaliser l sums the raw weights.
//
// Bound on the card: bytes. A (row, head) reads 2 * len * 64 cache values
// and does about 4 operations a value (1 to 4 operations a byte).
//
// Design, and what each part does about that bound:
//   - Positions in parallel, 16-byte loads. A lane group holds one
//     position's channels in 16-byte words, 128 bytes or more a group: a
//     head's 64 channels in 16 lanes (f32) or 8 (bf16), two heads' in 8
//     (int8: 4 lanes a head, and a CTA serves a pair of heads). A warp
//     reads 2 or 4 positions with one instruction, and a score is a
//     reduction within a head's lanes (4, 3 or 2 shuffles).
//   - One round trip a tile. A CTA of WARPS warps reads TILE positions a
//     tile, NP a thread (a warp takes TILE / WARPS consecutive ones); every
//     K and V load of a thread's positions (and their two int8 scales) is
//     issued before its first score, into registers. At the main path's 52
//     positions a (row, head) is one tile.
//   - Exponentials on log2-scaled scores (q carries d^-0.5 log2 e): within
//     a tile the warp's max comes first, then one pass takes the
//     exponentials, l and P.V; online softmax only across tiles, with f32
//     sums. The warps' states meet once, in shared memory.
//   - int8 without a conversion instruction: a byte permute places the
//     biased code under the exponent of 2^23, one FADD removes the bias.
//     One lane of a head loads K's scale, another V's, and shuffles share
//     them.
//   - No split along T: the grid is (head groups, rows), one CTA each. The
//     main path's caches are one tile, and at the JAX bench's batches the
//     rows and heads alone fill the card (PERF.md).
//   - `layer_idx`, the length and `row_map` are device values read once
//     by each CTA, so a CUDA graph captures the token loop.
// PERF.md gives the choices (4 warps, 64 positions a tile, no prefetch of
// the next tile into registers, int8 in pairs of heads, the byte-permute
// unpack) and what was measured against them.

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace self_read {

using flash::HD;
using flash::LOG2E;
using flash::sm90::ex2;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;       // positions a CTA reads in one round trip
constexpr unsigned FULL = 0xffffffffu;

// DECODE: the normalised output with the new token merged last.
// SETTLED: the state (m, l, acc), m in natural units; no new token.
enum Mode { DECODE = 0, SETTLED = 1 };

struct Params {
  const void *q, *k_new, *v_new;  // (rows, n_state) in T; q unscaled
  const void *kc, *vc;            // (layers, rows_phys, t_pad, n_state) in C
  const __nv_bfloat16* scales;    // (layers, rows_phys, t_pad, 128) (int8 cache)
  const int *layer_idx, *len;     // positions [0, len) are read: pos or settled
  const int* row_map;             // (rows,) physical row of each row, or NULL
  void* out;                      // (rows, n_state) in T (DECODE)
  float *m_out, *l_out, *acc_out;  // (rows, heads) twice, (rows, n_state) (SETTLED)
  int rows_phys, heads, t_pad;
};

// a 16-byte word of type E as f32 values; int8 codes are biased to [0,
// 255] and put under the exponent of 2^23 by a byte permute: 2^23 + code +
// 128 is exact in f32, and one FADD leaves the code
template <typename E>
__device__ __forceinline__ void unpack(const uint4& u, float* x) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<E, float>::value) {
      x[i] = __uint_as_float(v[i]);
    } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
      x[2 * i] = __uint_as_float(v[i] << 16);
      x[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
    } else {
      const uint32_t b = v[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + j)) - 8388736.f;
    }
  }
}

template <typename T, typename C, int MODE>
__global__ void __launch_bounds__(THREADS) self_cache_read_kernel(const Params p) {
  // a lane's channels (4, 8, 16 for f32, bf16, int8), a head's lanes (16, 8,
  // 4), a CTA's heads (1, 1, 2), a position's lanes, a warp load's
  // positions, a thread's positions a tile (8, 4, 4)
  constexpr bool QUANT = sizeof(C) == 1;
  constexpr int CPL = 16 / sizeof(C), LPH = HD / CPL, HPC = QUANT ? 2 : 1, LPP = LPH * HPC;
  constexpr int PPW = 32 / LPP, NP = TILE / (WARPS * PPW), W = HPC * HD;  // W: a CTA's channels
  constexpr int SPAN = PPW * NP;  // consecutive positions a warp takes a tile
  // every warp's state (acc, then m and l a head)
  __shared__ float st[WARPS][W + 2 * HPC], s_new_of[HPC];

  const int ri = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LPP, sub = lane % LPP;  // position slot, word of the position
  const int hs = sub / LPH, h_lane = sub % LPH;        // this lane's head in the CTA, lane in it
  const int hi = blockIdx.x * HPC + hs;                // its head
  const bool own = hi < p.heads;                       // false past an odd head count
  const int n_state = p.heads * HD;
  const size_t row = (size_t)ri * n_state + blockIdx.x * W;  // the CTA's first channel

  // the scalars, q (this lane's channels) and the new token
  const int layer = *p.layer_idx;
  const int len = max(0, min(*p.len, p.t_pad));
  const int phys = p.row_map ? p.row_map[ri] : ri;
  float qv[CPL], kn[CPL], vn = 0.f;
  for (int w = 0; w < CPL * (int)sizeof(T) / 16; ++w) {  // 16-byte words of T
    const size_t at = row + sub * CPL + w * 16 / sizeof(T);
    unpack<T>(own ? __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(p.q) + at))
                  : make_uint4(0, 0, 0, 0), qv + w * 16 / sizeof(T));
    if (MODE == DECODE)
      unpack<T>(own ? __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(p.k_new) + at))
                    : make_uint4(0, 0, 0, 0), kn + w * 16 / sizeof(T));
  }
  if (MODE == DECODE && tid < W && blockIdx.x * HPC + tid / HD < p.heads)
    vn = float(static_cast<const T*>(p.v_new)[row + tid]);

  const int n = (len + TILE - 1) / TILE;  // tiles of [0, len)

  const size_t slab = ((size_t)layer * p.rows_phys + phys) * p.t_pad;
  const size_t base = slab * n_state + blockIdx.x * W + sub * CPL;
  const C* kb = static_cast<const C*>(p.kc) + base;
  const C* vb = static_cast<const C*>(p.vc) + base;
  // int8: lane 0 of a head loads K's scale, lane 1 V's
  const __nv_bfloat16* sb =
      QUANT ? p.scales + slab * 128 + (h_lane == 0 ? hi : p.heads + hi) : nullptr;
  const int first = warp * SPAN + grp;  // this thread's first position in a tile
  uint4 kw[NP], vw[NP];
  __nv_bfloat16 sc[NP];
  auto issue = [&](int tile) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int t = tile * TILE + first + j * PPW;
      const bool live = t < len && own;
      const size_t off = (size_t)(live ? t : 0) * n_state;
      kw[j] = live ? __ldg(reinterpret_cast<const uint4*>(kb + off)) : make_uint4(0, 0, 0, 0);
      vw[j] = live ? __ldg(reinterpret_cast<const uint4*>(vb + off)) : make_uint4(0, 0, 0, 0);
      if constexpr (QUANT)
        sc[j] = live && h_lane < 2 ? sb[(size_t)t * 128] : __float2bfloat16(0.f);
    }
  };
  if (n > 0) issue(0);

  // q scaled once: scores come out in log2 units
  float s_new = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    qv[c] *= 0.125f * LOG2E;  // 64^-0.5 log2 e
    if constexpr (MODE == DECODE) s_new = fmaf(qv[c], kn[c], s_new);
  }
  if constexpr (MODE == DECODE) {
    for (int off = 1; off < LPH; off <<= 1) s_new += __shfl_xor_sync(FULL, s_new, off);
    if (warp == 0 && grp == 0 && h_lane == 0) s_new_of[hs] = s_new;
  }

  float m = -INFINITY, l = 0.f, acc[CPL], x[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  for (int tile = 0; tile < n; ++tile) {
    if (tile > 0) issue(tile);
    if (tile * TILE + warp * SPAN >= len) continue;  // the warp holds no live position
    float s[NP], vs[NP], mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      unpack<C>(kw[j], x);
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; c += 2) {
        a = fmaf(qv[c], x[c], a);
        b = fmaf(qv[c + 1], x[c + 1], b);
      }
      s[j] = a + b;
    }
    for (int off = 1; off < LPH; off <<= 1)
      for (int j = 0; j < NP; ++j) s[j] += __shfl_xor_sync(FULL, s[j], off);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if constexpr (QUANT) {
        const float f = __bfloat162float(sc[j]);
        s[j] *= __shfl_sync(FULL, f, lane - h_lane);
        vs[j] = __shfl_sync(FULL, f, lane - h_lane + 1);
      }
      if (tile * TILE + first + j * PPW >= len) s[j] = -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    for (int off = LPP; off < 32; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
    const float mn = fmaxf(m, mt);    // finite: the warp holds a live position
    const float alpha = ex2(m - mn);  // 0 while m is -inf
    l *= alpha;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] *= alpha;
    m = mn;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float pj = ex2(s[j] - mn);  // a masked position: 2^-inf = 0
      const float pv = QUANT ? pj * vs[j] : pj;
      l += pj;
      unpack<C>(vw[j], x);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] = fmaf(pv, x[c], acc[c]);
    }
  }

  // the warp's state: its groups' shares summed (m is one a head across
  // the warp), written into shared memory
  for (int off = LPP; off < 32; off <<= 1) {
    l += __shfl_xor_sync(FULL, l, off);
    for (int c = 0; c < CPL; ++c) acc[c] += __shfl_xor_sync(FULL, acc[c], off);
  }
  float* dst = &st[warp][0];
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) dst[sub * CPL + c] = acc[c];
    if (h_lane == 0) {
      dst[W + hs] = m;
      dst[W + HPC + hs] = l;
    }
  }
  __syncthreads();
  // the warps merged in warp order, one thread a channel
  const int ch = tid / HD;  // the head in the CTA of channel tid
  if (tid >= W || blockIdx.x * HPC + ch >= p.heads) return;
  float mc = -INFINITY, num = 0.f, den = 0.f;
  for (int r = 0; r < WARPS; ++r) mc = fmaxf(mc, st[r][W + ch]);
  for (int r = 0; r < WARPS; ++r) {
    const float wgt = st[r][W + ch] == -INFINITY ? 0.f : ex2(st[r][W + ch] - mc);
    num = fmaf(wgt, st[r][tid], num);
    den = fmaf(wgt, st[r][W + HPC + ch], den);
  }

  if constexpr (MODE == DECODE) {
    // the new token last; with no cache position its weight is exactly 1
    const float sn = s_new_of[ch];
    const float mf = fmaxf(mc, sn);
    const float wc = mc == -INFINITY ? 0.f : ex2(mc - mf);
    const float pn = sn >= mc ? 1.f : ex2(sn - mf);
    const float o = fmaf(num, wc, pn * vn) / fmaf(den, wc, pn);
    static_cast<T*>(p.out)[row + tid] = T(o);  // bf16: round to nearest even
  } else {
    p.acc_out[row + tid] = num;
    if (tid % HD == 0) {
      const size_t at = (size_t)ri * p.heads + blockIdx.x * HPC + ch;
      p.m_out[at] = mc == -INFINITY ? -1e30f : mc * 0.6931471805599453f;  // ln 2
      p.l_out[at] = den;
    }
  }
}

// one launch: grid (head groups, rows); a shape no entry takes returns an
// error
template <typename T, typename C, int MODE>
int launch(const Params& p, int rows, int head_dim, void* stream) {
  if (head_dim != HD || p.t_pad <= 0 || rows <= 0 || rows > 65535 || p.heads <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = sizeof(C) == 1 ? (p.heads + 1) / 2 : p.heads;  // int8 pairs heads
  self_cache_read_kernel<T, C, MODE>
      <<<dim3(groups, rows), THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace self_read

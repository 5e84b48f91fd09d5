// One-query cross attention over quantized encoder K/V (the decode loop).
//
// Replaces the TPU kernels `_kernel` (group 1, decode_attention.py:79) and
// `_kernel_grouped` (group > 1, decode_attention.py:156) of the JAX
// package's ops/decode_attention.py, entry `decode_cross_attention`:
// softmax(q . K) V for `group` queries per (batch, head) against K/V stored
// transposed as (layers, batch, heads, d[/2], T_pad), the layer's slab picked
// by `layer_idx` and positions >= `kv_len` masked. With group > 1 the
// queries are the beams of one utterance and share its one K/V read.
// Storage is packed int4 (two channels a byte: channel i in the low nibble,
// i + d/2 in the high one), int8, bf16 or f32. The kernel reads q in its own
// dtype (bf16 or f32) through its strides and forms (q * d^-0.5) * k_scale
// in the wrapper's order; v_scale and v_zp are applied by the caller. The
// output is written in q's dtype (round to nearest even). The math is exact
// f32; the TPU route that truncates q and p to one bf16 MXU pass is not
// copied.
//
// With `return_state` (the time-minor self cache reads through this kernel
// and merges its new token outside) the output is f32 and the kernel also
// writes each query's online-softmax state: m, the largest live score, and
// l, the sum of exp(s - m) over the live positions. A query with no live
// position (kv_len == 0) gets m = -1e30 (the TPU kernel's NEG_INF), l = 0
// and a zero output, which weighs exactly 0 when the caller merges it. The
// TPU option `dynamic_grid` (read only the live chunks) is what this kernel
// always does.
//
// Bound on the card. Each (batch, head) reads d/2 * kv_len bytes of packed
// K and as many of V; per packed byte the group does 2G FMAs for the scores
// and 2G for the values. At group 1 that is bytes (a greedy step at batch 4
// moves 6.2 MB, 1.9 us at 3.35 TB/s). At G = 5 the f32 FMAs take about as
// long as the bytes (62 M FMAs, 1.85 us at 33.5 T FMA/s). Below those, a
// tile's instructions bound it: at batch 4 every SM issues about one
// instruction a clock, so the design counts instructions as much as bytes.
//
// Design, and what each part does about that bound:
//   - T is split across a thread-block cluster: the grid is (S, heads,
//     batch) and each (batch, head) gets a cluster of S <= 8 CTAs along T,
//     so a small batch still fills the SMs. The host picks S from the shapes
//     alone (`choose_splits` in ops/decode_attention.py): as many as keep
//     the CTAs at or under one an SM (a second CTA on an SM only shares its
//     issue slots, and a larger cluster costs more to launch and to merge:
//     S = 2 at batch 4 x 16 heads measured faster than 3, 4, 6 or 8), two
//     tiles or more a CTA (a cluster of two costs more than a tile), S = 1
//     where batch * heads already fills the card, never an empty rank when
//     every position is live; kv_len stays on the device. Each CTA takes a
//     tile-aligned chunk of [0, kv_len); a chunk wholly past kv_len is empty
//     and adds exactly nothing.
//   - A ring of STAGES tiles in shared memory (TILE positions of K and of V,
//     requested together with 16-byte cp.async; positions past kv_len are
//     zero-filled, never read) keeps up to STAGES - 1 tiles in flight, and
//     V's latency hides under the scores; one barrier a tile. Rows are
//     padded in shared memory so the compute reads are free of bank
//     conflicts. A row's stride must be a multiple of 16 bytes: the cross
//     cache is padded to 1536 positions, the time-minor cache to a multiple
//     of 128, and the wrapper pads any other T (a copy) rather than keep a
//     narrow-copy path here.
//   - Every thread works on every tile: a thread owns a quad of positions
//     and a slice of channel rows; the partial dots of a quad's slices meet
//     by shuffles, and each thread carries its own online-softmax state
//     (m, l, and acc for its channels, per query) across tiles in
//     registers, rescaling acc only when a warp's max moved; exp is one
//     FFMA and one ex2. No score array scales with T, so a group of up to 8
//     is one launch at any T_pad.
//   - The unpack has no conversion instruction. Packed int4 costs one LOP3
//     a value (the codes enter the FMAs as subnormal floats, see Q_SHIFT);
//     int8 a byte permute under the exponent of 2^23 and one FADD.
//   - The CTAs of a cluster merge through distributed shared memory: each
//     writes its (m, l, acc) into rank 0's shared memory (remote stores, no
//     remote load latency), one cluster barrier releases them, and rank 0
//     merges the ranks in rank order by the online-softmax rule. For a given
//     S the bits are the same on every run; there are no atomics.
//   - q's cast and both scalings and the output's cast happen here, so a
//     call with group <= 8 is one launch; q's loads are the kernel's first,
//     beside the scalars'.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::LOG2E;
using flash::smem_addr;
using flash::sm90::cp_async;
using flash::sm90::cp_async_commit;
using flash::sm90::cp_async_wait;
using flash::sm90::cp_async_wait_all;
using flash::sm90::ex2;

constexpr int HD = 64;        // head_dim
constexpr int THREADS = 256;  // per CTA
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;       // queries a CTA serves
constexpr int MAX_SPLITS = 8;  // CTAs of a cluster (the portable limit)
constexpr unsigned FULL = 0xffffffffu;

enum Mode { PACKED4 = 0, INT8 = 1, BF16 = 2, F32 = 3 };

template <int MODE>
struct Cfg {
  static constexpr int ESIZE = MODE == F32 ? 4 : MODE == BF16 ? 2 : 1;  // bytes an element
  static constexpr int ROWS = MODE == PACKED4 ? HD / 2 : HD;  // stored channel rows
  static constexpr int TILE = ESIZE == 1 ? 128 : 64;          // positions a tile
  static constexpr int ROW_BYTES = TILE * ESIZE;              // 128, or 256 for f32
  // shared-memory row pitch: 16-byte aligned, and the compute reads of a
  // warp land on distinct banks
  static constexpr int PITCH = ROW_BYTES + (MODE == F32 ? 32 : 16);
  static constexpr int QUADS = TILE / 4;        // position quads a tile
  static constexpr int SLICES = THREADS / QUADS;  // threads sharing a quad: 8 or 16
  static constexpr int QPW = 32 / SLICES;       // quads a warp: 4 or 2
  static constexpr int RPT = ROWS / SLICES;     // rows a thread: 4, 8, 4, 4
  static constexpr int CPT = MODE == PACKED4 ? 2 * RPT : RPT;  // channels a thread
  static constexpr int STAGES = MODE == F32 ? 2 : MODE == BF16 ? 3 : 4;
  static constexpr int HALF = ROWS * PITCH;  // K or V of one tile
  static constexpr int RING_BYTES = STAGES * 2 * HALF;
  static_assert(RPT * SLICES == ROWS && CPT % 4 == 0, "thread split");
};

struct Params {
  const void* q;         // (batch, heads, G, 64) through q_sb, q_sh, q_sg
  const float* k_scale;  // (batch, heads, 64) or NULL
  const void* kt;
  const void* vt;
  const int* layer_idx;  // NULL: one layer
  const int* kv_len;
  void* out;       // (batch, heads, G, 64): q's dtype, f32 with the state
  float* m_out;    // (batch, heads, G) or NULL
  float* l_out;
  int batch, heads, t_pad;
  int q_sb, q_sh, q_sg;  // q strides in elements (channel stride 1)
  int q_bf16;            // q (and, without the state, out) is bf16, else f32
};

// 4 consecutive positions of one channel row of a tile in shared memory,
// as f32; for packed int4 `lo` gets the low nibbles, `hi` the high ones.
// The int codes are biased to [0, 255] and placed under the exponent of
// 2^23 by a byte permute: 2^23 + code - bias is exact in f32.
// Packed int4 enters the FMAs as biased codes (code + 8, in [0, 15]) held as
// subnormal floats: a nibble flipped and masked in place at bit b of a word
// is the float (code + 8) 2^(b - 149), exact, one LOP3 each. Position j's
// low nibble sits at bit b(j) = 0, 8, 8, 12 (j = 2 and 3 from the word
// shifted right by 8 and 12) and its high nibble at b(j) + 4, so the high
// channels' q carries 2^-4 more. With q scaled by 2^Q_SHIFT and p by
// 2^p_exp(j) (exact powers of two) no product or sum leaves the normal
// range, and each keeps its full f32 precision. The bias leaves once per
// score (8 sum(q), a shift every score of a query shares: softmax ignores
// it, and m gives it back) and once per output channel (8 l).
constexpr int Q_SHIFT = 100;
// a score of position j times 2^(149 - Q_SHIFT - b(j)) is the biased score
__device__ __forceinline__ constexpr float s_scale(int j) {
  return j == 0 ? 0x1p49f : j == 3 ? 0x1p37f : 0x1p41f;
}
// p of position j enters acc as p 2^p_exp(j) = p 2^(149 - b(j) - 24)
__device__ __forceinline__ constexpr float p_exp(int j) {
  return j == 0 ? 125.f : j == 3 ? 113.f : 117.f;
}
__device__ __forceinline__ constexpr float p_undo(int j) {
  return j == 0 ? 0x1p-125f : j == 3 ? 0x1p-113f : 0x1p-117f;
}

template <int MODE>
__device__ __forceinline__ void unpack4(const unsigned char* src, float lo[4],
                                        float hi[4]) {
  if constexpr (MODE == PACKED4) {  // code + 8 = code ^ 8, see Q_SHIFT
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
    const uint32_t w8 = w >> 8, w12 = w >> 12;
    lo[0] = __uint_as_float((w & 0xFu) ^ 0x8u);
    hi[0] = __uint_as_float((w & 0xF0u) ^ 0x80u);
    lo[1] = __uint_as_float((w & 0xF00u) ^ 0x800u);
    hi[1] = __uint_as_float((w & 0xF000u) ^ 0x8000u);
    lo[2] = __uint_as_float((w8 & 0xF00u) ^ 0x800u);
    hi[2] = __uint_as_float((w8 & 0xF000u) ^ 0x8000u);
    lo[3] = __uint_as_float((w12 & 0xF000u) ^ 0x8000u);
    hi[3] = __uint_as_float((w12 & 0xF0000u) ^ 0x80000u);
  } else if constexpr (MODE == INT8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src) ^ 0x80808080u;  // byte + 128
#pragma unroll
    for (int j = 0; j < 4; ++j)
      lo[j] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + j)) - 8388736.f;
  } else if constexpr (MODE == BF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    lo[0] = __uint_as_float(w.x << 16);
    lo[1] = __uint_as_float(w.x & 0xFFFF0000u);
    lo[2] = __uint_as_float(w.y << 16);
    lo[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
    const float4 w = *reinterpret_cast<const float4*>(src);
    lo[0] = w.x;
    lo[1] = w.y;
    lo[2] = w.z;
    lo[3] = w.w;
  }
}

// This thread's share of copying a tile of K and V into the ring: 16-byte
// words tid + j * THREADS of K's rows, then V's; consecutive threads take
// consecutive words of a row. Words at or past kv_len are zero-filled and
// never read.
template <int MODE>
struct TileCopy {
  using C = Cfg<MODE>;
  static constexpr int WPR = C::ROW_BYTES / 16;  // words a row
  static constexpr int RPJ = THREADS / WPR;      // rows a pass covers
  static constexpr int PASSES = C::ROWS / RPJ;   // passes over K (and V)
  const unsigned char* src;  // this thread's first word of the slab's K
  size_t v_off;              // V's slab minus K's
  size_t stride;             // row stride in bytes
  uint32_t dst;              // its first word in a stage
  int pos;                   // its word's first position within a tile

  __device__ __forceinline__ TileCopy(const unsigned char* k, const unsigned char* v,
                                      size_t row_stride) {
    const int row = threadIdx.x / WPR, col = threadIdx.x % WPR;
    src = k + row * row_stride + col * 16;
    v_off = v - k;
    stride = row_stride;
    dst = row * C::PITCH + col * 16;
    pos = col * 16 / C::ESIZE;
  }

  __device__ __forceinline__ void issue(uint32_t stage, int tile, int kv_len) const {
    const bool live = tile * C::TILE + pos < kv_len;
    const unsigned char* s = src + (size_t)tile * C::ROW_BYTES;
#pragma unroll
    for (int j = 0; j < 2 * PASSES; ++j) {
      const int which = j / PASSES, r = (j % PASSES) * RPJ;
      const unsigned char* g = s + (which ? v_off : 0) + r * stride;
      cp_async<16>(stage + dst + which * C::HALF + r * C::PITCH, live ? g : src, live ? 16 : 0);
    }
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int MODE, int G>
__global__ void __launch_bounds__(THREADS, G <= 5 ? 2 : 1)
    decode_cross_kernel(const Params p) {
  using C = Cfg<MODE>;
  constexpr int C4 = C::CPT / 4;
  constexpr int ST = HD + 2;  // a query's state: acc[64], m, l
  extern __shared__ __align__(16) unsigned char ring[];
  // scaled q permuted to each slice's channels, 4 a float4
  __shared__ __align__(16) float qp[G][C4][C::SLICES][4];
  __shared__ float red_m[WARPS][G], red_l[WARPS][G];  // a warp's max and sum
  __shared__ float st_all[MAX_SPLITS][G][ST];  // rank 0: every rank's state

  if (gridDim.x > 1) cluster_arrive_relaxed();  // waited for before the first remote write
  const int rank = blockIdx.x, splits = gridDim.x;
  const int hi = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int slice = lane / C::QPW, quad = warp * C::QPW + lane % C::QPW;

  // q and its K scales first: their loads overlap the scalars' and the tiles'
  constexpr int QPT = (G * HD + THREADS - 1) / THREADS;  // q elements a thread
  const size_t head = (size_t)bi * p.heads + hi;
  float qx[QPT], qk[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * THREADS, g = i / HD, c = i % HD;
    if (i < G * HD) {
      const size_t at = (size_t)bi * p.q_sb + (size_t)hi * p.q_sh + (size_t)g * p.q_sg + c;
      qx[k] = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
                       : static_cast<const float*>(p.q)[at];
      qk[k] = p.k_scale ? p.k_scale[head * HD + c] : 1.f;
    }
  }
  const int layer = p.layer_idx ? *p.layer_idx : 0;
  const int kv_len = max(0, min(*p.kv_len, p.t_pad));
  const size_t row_stride = (size_t)p.t_pad * C::ESIZE;
  const size_t slab = (((size_t)layer * p.batch + bi) * p.heads + hi) * C::ROWS * row_stride;
  const TileCopy<MODE> copy(static_cast<const unsigned char*>(p.kt) + slab,
                            static_cast<const unsigned char*>(p.vt) + slab, row_stride);
  const uint32_t ring_s = smem_addr(ring);

  // this rank's tiles: [t0, t0 + n)
  const int live_tiles = (kv_len + C::TILE - 1) / C::TILE;
  const int per = (live_tiles + splits - 1) / splits;
  const int t0 = min(rank * per, live_tiles);
  const int n = min(t0 + per, live_tiles) - t0;

#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < n) copy.issue(ring_s + i * 2 * C::HALF, t0 + i, kv_len);
    cp_async_commit();
  }

  // (float(q) * d^-0.5) * k_scale, in the order PyTorch takes them, then
  // permuted to the slices
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * THREADS, g = i / HD, c = i % HD;
    if (i < G * HD) {
      float x = __fmul_rn(qx[k], 0.125f);  // 64^-0.5, exact
      if (p.k_scale) x = __fmul_rn(x, qk[k]);
      const int r = MODE == PACKED4 ? c % (HD / 2) : c;  // stored row of channel c
      if constexpr (MODE == PACKED4) x *= c < HD / 2 ? 0x1p100f : 0x1p96f;  // see Q_SHIFT
      const int slot = r / C::SLICES + (MODE == PACKED4 && c >= HD / 2 ? C::RPT : 0);
      qp[g][slot / 4][r % C::SLICES][slot % 4] = x;
    }
  }

  // a group of one or two keeps its q in registers across tiles
  float4 qreg[G <= 2 ? G : 1][C4];
  if constexpr (G <= 2) {
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4)
        qreg[g][c4] = *reinterpret_cast<const float4*>(qp[g][c4][slice]);
  }

  float m[G], l[G], acc[G][C::CPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[g][c] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    cp_async_wait<C::STAGES - 2>();
    // tile i has landed for every thread, qp is written, and every thread
    // is done with tile i - 1, whose stage takes tile i + STAGES - 1
    __syncthreads();
    if (i + C::STAGES - 1 < n)
      copy.issue(ring_s + ((i + C::STAGES - 1) % C::STAGES) * 2 * C::HALF,
                 t0 + i + C::STAGES - 1, kv_len);
    cp_async_commit();
    const unsigned char* kt = ring + (i % C::STAGES) * 2 * C::HALF + quad * 4 * C::ESIZE;
    const unsigned char* vt = kt + C::HALF;

    // scores of this thread's quad over its rows, all G queries
    float x[C::CPT][4];
#pragma unroll
    for (int r = 0; r < C::RPT; ++r)
      unpack4<MODE>(kt + (slice + r * C::SLICES) * C::PITCH, x[r],
                    x[MODE == PACKED4 ? C::RPT + r : r]);
    float s[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[g][j] = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4) {
        float4 qv;
        if constexpr (G <= 2)
          qv = qreg[g][c4];
        else
          qv = *reinterpret_cast<const float4*>(qp[g][c4][slice]);
        const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[g][j] = fmaf(qq[k], x[4 * c4 + k][j], s[g][j]);
      }
    }
    // the slices of a quad are lanes QPW apart: sum their partial dots
#pragma unroll
    for (int off = C::QPW; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[g][j] += __shfl_xor_sync(FULL, s[g][j], off);
    if constexpr (MODE == PACKED4)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[g][j] *= s_scale(j);  // + 8 sum(q), see Q_SHIFT

    // online softmax of the quad's 4 positions; acc is rescaled only when
    // some thread of the warp saw its max move
    if ((t0 + i + 1) * C::TILE > kv_len) {  // the tile that holds kv_len
      const int pos = (t0 + i) * C::TILE + quad * 4;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (pos + j >= kv_len) s[g][j] = -INFINITY;
    }
    bool moved = false;
    float mn[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mn[g] = fmaxf(fmaxf(fmaxf(m[g], s[g][0]), fmaxf(s[g][1], s[g][2])), s[g][3]);
      moved |= mn[g] > m[g];
    }
    if (__any_sync(FULL, moved)) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // exp(-inf) = 0 clears a state that saw nothing yet; no max, no change
        const float sc = mn[g] == -INFINITY ? 1.f : __expf(m[g] - mn[g]);
        l[g] *= sc;
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) acc[g][c] *= sc;
        m[g] = mn[g];
      }
    }
#pragma unroll
    for (int r = 0; r < C::RPT; ++r)
      unpack4<MODE>(vt + (slice + r * C::SLICES) * C::PITCH, x[r],
                    x[MODE == PACKED4 ? C::RPT + r : r]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // exp(s - m) as 2^(s log2 e - m log2 e); masked: 2^-inf = 0
      const float mref = m[g] == -INFINITY ? 0.f : -m[g] * LOG2E;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (MODE == PACKED4) {  // pj = p 2^p_exp(j)
          const float pj = ex2(fmaf(s[g][j], LOG2E, mref + p_exp(j)));
          l[g] = fmaf(pj, p_undo(j), l[g]);
#pragma unroll
          for (int c = 0; c < C::CPT; ++c) acc[g][c] = fmaf(pj, x[c][j], acc[g][c]);
          continue;
        }
        const float pj = ex2(fmaf(s[g][j], LOG2E, mref));
        l[g] += pj;
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) acc[g][c] = fmaf(pj, x[c][j], acc[g][c]);
      }
    }
  }
  cp_async_wait_all();  // only empty groups can remain
  if constexpr (MODE == PACKED4)  // acc held sum p (code + 8) 2^-24, 2^-20 high
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < C::CPT; ++c)
        acc[g][c] = fmaf(acc[g][c], c < C::RPT ? 0x1p24f : 0x1p20f, -8.f * l[g]);

  // the CTA's state: the max over its quads; each thread's share rescaled
  // to it and summed over the quads of its warp (lanes 1..QPW/2 apart),
  // then over warps in order through the ring, now free
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mw = m[g];
#pragma unroll
    for (int off = 1; off < C::QPW; off <<= 1) mw = fmaxf(mw, __shfl_xor_sync(FULL, mw, off));
    if (lane == 0) red_m[warp][g] = mw;
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);  // [WARPS][G][HD]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mc = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mc = fmaxf(mc, red_m[w][g]);
    const float wgt = m[g] == -INFINITY ? 0.f : __expf(m[g] - mc);
    l[g] *= wgt;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[g][c] *= wgt;
#pragma unroll
    for (int off = 1; off < C::QPW; off <<= 1) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[g][c] += __shfl_xor_sync(FULL, acc[g][c], off);
    }
    if (lane % C::QPW == 0) {
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) {
        const int r = slice + (c % C::RPT) * C::SLICES;
        part[(warp * G + g) * HD + (MODE == PACKED4 && c >= C::RPT ? r + HD / 2 : r)] =
            acc[g][c];
      }
    }
    if (lane == 0) red_l[warp][g] = l[g];
  }
  __syncthreads();

  // every rank writes its state into rank 0's shared memory, then rank 0
  // merges them in rank order and writes the result (one CTA, launched
  // without a cluster, skips the cluster barriers)
  cg::cluster_group cluster = cg::this_cluster();
  float* mine = &st_all[0][0][0];
  if (splits > 1) {
    cluster_wait();  // every CTA of the cluster has started
    mine = cluster.map_shared_rank(mine, 0) + rank * G * ST;
  }
  for (int i = tid; i < G * HD; i += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += part[w * G * HD + i];
    mine[(i / HD) * ST + i % HD] = a;
  }
  if (tid < G) {
    float mc = -INFINITY, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mc = fmaxf(mc, red_m[w][tid]);
      a += red_l[w][tid];
    }
    mine[tid * ST + HD] = mc;
    mine[tid * ST + HD + 1] = a;
  }
  if (splits > 1)
    cluster.sync();  // release the writes to rank 0, which acquires them
  else
    __syncthreads();
  if (rank != 0) return;
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, c = i % HD;
    float mt = -INFINITY;
    for (int r = 0; r < splits; ++r) mt = fmaxf(mt, st_all[r][g][HD]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float mr = st_all[r][g][HD];
      const float w = mr == -INFINITY ? 0.f : __expf(mr - mt);
      num = fmaf(w, st_all[r][g][c], num);
      den = fmaf(w, st_all[r][g][HD + 1], den);
    }
    const float o = num / fmaxf(den, 1e-30f);
    const size_t at = (head * G + g) * HD + c;
    if (p.m_out != nullptr) {
      static_cast<float*>(p.out)[at] = o;
      if (c == 0) {
        if constexpr (MODE == PACKED4) {  // the scores' shared shift
          float b = 0.f;
          for (int k = 0; k < C::SLICES * 4; ++k)
            b += (&qp[g][0][0][0])[k] * 0x1p-100f + (&qp[g][1][0][0])[k] * 0x1p-96f;
          mt -= 8.f * b;
        }
        p.m_out[head * G + g] = mt == -INFINITY ? -1e30f : mt;
        p.l_out[head * G + g] = den;
      }
    } else if (p.q_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(o);
    } else {
      static_cast<float*>(p.out)[at] = o;
    }
  }
}

template <int MODE, int G>
int launch(const Params& p, int splits, cudaStream_t st) {
  auto kernel = decode_cross_kernel<MODE, G>;
  constexpr int smem = Cfg<MODE>::RING_BYTES;
  // the ring and the static arrays may pass the 48 KB default together: opt
  // in once per instantiation
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.heads, p.batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one CTA is a cluster of its own
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_group(const Params& p, int group, int splits, cudaStream_t st) {
  switch (group) {
    case 1: return launch<MODE, 1>(p, splits, st);
    case 2: return launch<MODE, 2>(p, splits, st);
    case 3: return launch<MODE, 3>(p, splits, st);
    case 4: return launch<MODE, 4>(p, splits, st);
    case 5: return launch<MODE, 5>(p, splits, st);
    case 6: return launch<MODE, 6>(p, splits, st);
    case 7: return launch<MODE, 7>(p, splits, st);
    case 8: return launch<MODE, 8>(p, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (batch, heads, group, head_dim) bf16 (q_bf16 = 1) or f32, unscaled,
// element (b, h, g, c) at b * q_sb + h * q_sh + g * q_sg + c. k_scale:
// (batch, heads, head_dim) f32 or NULL. kt, vt: (layers, batch, heads,
// rows, t_pad) with rows = head_dim / 2 for mode 0 (packed int4), head_dim
// for modes 1 (int8), 2 (bf16), 3 (f32), 16-byte aligned, a row a multiple
// of 16 bytes. layer_idx: device
// int32 scalar or NULL (then layers = 1); kv_len: device int32 scalar.
// out: (batch, heads, group, head_dim), q's dtype, or f32 when m_out and
// l_out (batch, heads, group) f32 are given (the online-softmax state; both
// NULL or both given). group is 1..8, splits (CTAs along T, a cluster) is
// 1..8. Returns the launch's error: a cluster the card cannot place is
// refused, never retried another way.
extern "C" int decode_cross_attention(const void* q, const void* k_scale, const void* kt,
                                      const void* vt, const void* layer_idx,
                                      const void* kv_len, void* out, void* m_out,
                                      void* l_out, int batch, int heads, int head_dim,
                                      int t_pad, int group, int mode, int q_bf16, int q_sb,
                                      int q_sh, int q_sg, int splits, void* stream) {
  const int esize = mode == F32 ? 4 : mode == BF16 ? 2 : 1;
  if (head_dim != HD || t_pad <= 0 || (t_pad * esize) % 16 != 0 || group < 1 ||
      group > MAX_G || splits < 1 || splits > MAX_SPLITS || batch <= 0 || batch > 65535 ||
      heads <= 0 || heads > 65535 || (m_out == nullptr) != (l_out == nullptr) || mode < 0 ||
      mode > 3)
    return (int)cudaErrorInvalidValue;
  const Params p{q, (const float*)k_scale, kt, vt, (const int*)layer_idx,
                 (const int*)kv_len, out, (float*)m_out, (float*)l_out, batch, heads,
                 t_pad, q_sb, q_sh, q_sg, q_bf16 != 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case PACKED4: return launch_group<PACKED4>(p, group, splits, st);
    case INT8: return launch_group<INT8>(p, group, splits, st);
    case BF16: return launch_group<BF16>(p, group, splits, st);
    default: return launch_group<F32>(p, group, splits, st);
  }
}

// The bf16 flash-attention forward for Hopper, one kernel for both layouts.
//
// Replaces the TPU kernels `_attn_kernel_tmaj` (serving, the transposed
// (b*h, 64, T) layout) and `_attn_kernel` (training, row-major (b, T, heads,
// 64) with an optional additive mask and the log-sum-exp), JAX package
// ops/flash_attention.py. Both compute softmax(Q K^T / sqrt(d) [+ mask]) V
// with an f32 online softmax; P is rounded to bf16 before P V, as the TPU's
// default-precision dot rounds it. flash_attention_tmaj.cu and
// flash_attention.cu launch it for every bf16 input.
//
// Bound on the card: operations, twice. The two products take 4 * T^2 * 64
// tensor-core operations a head (0.038 ms at the serving call, 64 heads of
// T = 1516; 0.076 ms at the training call, 128 heads), and every score
// takes one exp2 on the special-function unit, 16 a clock an SM: about
// 0.035 and 0.070 ms. In series the two floors add to twice the bound.
//
// The design (FlashAttention-3's, at head_dim 64):
// - A block serves 64 * NWG queries of one head: warpgroup 0 loads, NWG
//   consumer warpgroups compute 64 query rows each, so every K/V tile in
//   shared memory serves 64 * NWG queries. The loader gives registers to
//   the consumers with setmaxnreg. Unmasked calls run NWG = 3 (192 queries,
//   512 threads, 32 registers a loader thread and 160 a consumer thread);
//   the masked instantiation, whose mask reads need more registers, runs
//   NWG = 2 (384 threads, 56 and 224).
// - Both products are wgmma: S = Q K^T with Q and K read from shared memory
//   through descriptors (m64n128k16), O += P V with P, the S accumulator
//   rounded to bf16, as the register A operand (m64n64k16). Every tile is
//   stored as 128-byte rows in the 128-byte swizzle: a row is a channel of
//   64 times (TMAJ, one tile per 64 times) or a time of 64 channels (ROWS),
//   so the layout changes only the descriptors' major-ness (the transpose
//   bits): TMAJ reads Q M-major, K N-major and V K-major; ROWS reads Q and K
//   K-major and V N-major.
// - The loader fills a ring of STAGES K/V stages ahead of the math with
//   cp.async (TMA needs 16-byte global strides, and the TMAJ stride at T =
//   1516 is 3032 B), in the widest word the layout's alignment allows (16 B
//   rows in ROWS; 16, 8 or 4 B along T in TMAJ as t_len allows, 2-byte loads
//   for odd t_len). A loader thread always moves the same words of a tile,
//   so its addresses are computed once. Words past the valid length are
//   written as zeros, so a ragged V tail is 0, never stale. Each loader
//   thread's copies arrive on the stage's "full" mbarrier as they land
//   (cp.async.mbarrier.arrive), so the loader only ever blocks on a free
//   stage; a consumer fences for the async proxy after its wait, and frees
//   the stage on its "empty" mbarrier when its wgmmas have read it.
// - Softmax under the tensor cores: the consumer warpgroups take turns on
//   named barriers, in a ring. A turn issues S_j = Q K_j^T and O += P_{j-1}
//   V_{j-1} back to back, then hands the tensor cores to the next warpgroup
//   and runs the softmax of S_j (ex2.approx on log2-scaled scores) while
//   the others' products run.
// - The epilogue divides by max(l, 1e-30), stages O in the warpgroup's own
//   Q tile and stores it with the widest aligned words: along T in TMAJ,
//   along rows in ROWS.
//
// Semantics pinned by the tests: keys at or past kv_len score -inf; a row
// whose scores are all -inf so far uses 0 as its reference maximum; lse =
// m ln2 + log l, -1e30 for an empty row; any T >= 1 and q_len != kv_len.
// The summation order does not depend on the layout, so both layouts give
// bit-identical outputs on the same data.

#pragma once

#include "sm90.cuh"

namespace flash {

namespace sm90 {

constexpr int BN = 128;       // keys per K/V tile
constexpr int STAGES = 4;     // K/V stages in the ring: two tiles ahead of the math
constexpr int TILE_BYTES = BN * HD * 2;  // one K or V tile

// NWG consumer warpgroups of 64 queries
template <int NWG>
struct Shape {
  static constexpr int BM = 64 * NWG;             // queries per block
  static constexpr int THREADS = 128 * (NWG + 1);  // the loader, then the consumers
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * TILE_BYTES + 1024;  // + alignment
  // registers a thread after setmaxnreg: the launch gives each of the
  // THREADS threads 65536 / THREADS (168 or 128); the loader gives back
  // what the consumers take
  static constexpr int LOAD_REGS = NWG == 2 ? 56 : 32;
  static constexpr int MMA_REGS = NWG == 2 ? 224 : 160;
  static_assert(128 * LOAD_REGS + 128 * NWG * MMA_REGS <= 65536, "register file");
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;                // (b * h, q_len), written when LSE
  const float* mask;         // read at MaskStrides when MASK
  int heads, q_len, kv_len;  // TMAJ: q_len == kv_len == t_len, heads unused
  MaskStrides ms;
  float scale_log2;
};

// ---- the two layouts ----
//
// A layout moves a tile of N times (N a multiple of 64: the Q tile, a K or V
// tile) of one head from device to shared memory, moves a warpgroup's 64 x
// 64 output tile from registers to device memory through shared memory, and
// names the descriptors of the three products.

// (b*h, 64, T) with T contiguous. A tile is N / 64 pieces of 64 channel rows
// of 64 times: time t of channel c at piece t / 64, row c, column t % 64.
// W: the load/store word in bytes (t_len % (W / 2) == 0).
template <int W>
struct Tmaj {
  static constexpr int E = W / 2;  // bf16 a word
  static constexpr int TA_S = 1, TB_S = 1, TB_PV = 0;  // Q M-, K N-, V K-major

  // this thread's part of a tile is in (2-byte words are stored in order)
  __device__ __forceinline__ static void signal(uint32_t bar) {
    if constexpr (W >= 4) cp_async_arrive(bar);
    else mbar_arrive(bar);
  }

  struct Head {
    const __nv_bfloat16 *q, *k, *v;
    __nv_bfloat16* o;
    int ld;  // t_len
  };
  __device__ __forceinline__ static Head head(const Params& p, int bh) {
    const size_t base = (size_t)bh * HD * p.kv_len;
    return {p.q + base, p.k + base, p.v + base, p.o + base, p.kv_len};
  }

  __device__ __forceinline__ static uint32_t off(int c, int t) {
    return (t >> 6) * HALF_BYTES + swz(c, (t & 63) >> 3) + (t & 7) * 2;
  }

  // A loader thread (tid in [0, 128)) moves the words at time column t of
  // channels c0 + CS k of every 64-time piece; their shared-memory offsets
  // repeat, but for the row, every 8 channels (the swizzle), so NPAT of
  // them are computed once.
  struct Loader {
    static constexpr int ROW = 64 / E;   // words a channel row of a piece
    static constexpr int CS = 128 / ROW; // channels a pass
    static constexpr int P = HD / CS;    // passes a piece
    static constexpr int NPAT = CS >= 8 ? 1 : 8 / CS;
    uint32_t pat[NPAT];
    int t;
    size_t goff;
    int ld;

    __device__ __forceinline__ Loader(int tid, int ld_) : ld(ld_) {
      const int c0 = tid / ROW;
      t = (tid % ROW) * E;
      goff = (size_t)c0 * ld + t;
#pragma unroll
      for (int u = 0; u < NPAT; ++u) pat[u] = off(c0 + CS * u, t);
    }

    // times [t0, t0 + N) of every channel into the tile at dst, zeros at or
    // past n
    template <int N>
    __device__ __forceinline__ void load(uint32_t dst, char* dst_ptr,
                                         const __nv_bfloat16* src, int t0, int n) const {
#pragma unroll
      for (int piece = 0; piece < N / 64; ++piece) {
        const int tp = t0 + 64 * piece;
        const bool ok = tp + t < n;
        const __nv_bfloat16* g = ok ? src + goff + tp : src;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const uint32_t d = piece * HALF_BYTES + pat[k % NPAT] + (k / NPAT) * NPAT * CS * 128;
          if constexpr (W >= 4) {
            cp_async<W>(dst + d, g + (size_t)k * CS * ld, ok ? W : 0);
          } else {
            // 2-byte words: a pointer stepped a channel group at a time
            // (opaque, so its P offsets are not all held in registers)
            *reinterpret_cast<__nv_bfloat16*>(dst_ptr + d) = ok ? *g : __float2bfloat16(0.f);
            g += (size_t)CS * ld;
            asm volatile("" : "+l"(g)::"memory");
          }
        }
      }
    }
  };

  // S = Q K^T over channels 16 kk .. 16 kk + 15
  __device__ __forceinline__ static uint64_t desc_q(uint32_t q_half, int kk) {
    return desc(q_half + kk * 2048, HALF_BYTES, 1024);
  }
  __device__ __forceinline__ static uint64_t desc_k(uint32_t k_tile, int kk) {
    return desc(k_tile + kk * 2048, HALF_BYTES, 1024);
  }
  // O += P V over keys 16 kk .. 16 kk + 15
  __device__ __forceinline__ static uint64_t desc_v(uint32_t v_tile, int kk) {
    return desc(v_tile + (kk >> 2) * HALF_BYTES + (kk & 3) * 32, 16, 1024);
  }

  // o[i]: row (query) r0 or r0 + 8 (i & 2), channel 8 (i >> 2) + 2 qd + (i & 1)
  __device__ __forceinline__ static void stage(char* half, const float (&o)[32], int r0,
                                               int qd, float inv0, float inv1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * qd + (i & 1), r = r0 + ((i & 2) ? 8 : 0);
      *reinterpret_cast<__nv_bfloat16*>(half + swz(c, r >> 3) + (r & 7) * 2) =
          __float2bfloat16(o[i] * ((i & 2) ? inv1 : inv0));
    }
  }
  // a staged 64 x 64 tile (channels x queries [q0, q0 + 64)) to device memory
  __device__ __forceinline__ static void store(__nv_bfloat16* dst, int ld, const char* half,
                                               int q0, int n, int tid) {
    constexpr int ROW = 64 / E;
#pragma unroll
    for (int i = tid; i < HD * ROW; i += 128) {
      const int c = i / ROW, t = (i % ROW) * E;
      if (q0 + t >= n) continue;
      const char* s = half + swz(c, t >> 3) + (t & 7) * 2;
      __nv_bfloat16* d = dst + (size_t)c * ld + q0 + t;
      if constexpr (W == 16) *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      if constexpr (W == 8) *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
      if constexpr (W == 4) *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
      if constexpr (W == 2) *d = *reinterpret_cast<const __nv_bfloat16*>(s);
    }
  }
};

// (b, T, heads, 64) with rows heads * 64 apart (sm90.cuh's row tiles)
struct Rows : RowTiles {
  static constexpr int TA_S = 0, TB_S = 0, TB_PV = 1;  // Q, K K-major; V N-major

  struct Head {
    const __nv_bfloat16 *q, *k, *v;
    __nv_bfloat16* o;
    int ld;  // heads * 64
  };
  __device__ __forceinline__ static Head head(const Params& p, int bh) {
    const int bi = bh / p.heads, hi = bh % p.heads;
    const size_t ld = (size_t)p.heads * HD;
    const size_t qo = (size_t)bi * p.q_len * ld + hi * HD;
    const size_t ko = (size_t)bi * p.kv_len * ld + hi * HD;
    return {p.q + qo, p.k + ko, p.v + ko, p.o + qo, (int)ld};
  }

  __device__ __forceinline__ static uint64_t desc_q(uint32_t q_half, int kk) {
    return desc_rows(q_half, kk);
  }
  __device__ __forceinline__ static uint64_t desc_k(uint32_t k_tile, int kk) {
    return desc_rows(k_tile, kk);
  }
  __device__ __forceinline__ static uint64_t desc_v(uint32_t v_tile, int kk) {
    return desc_cols(v_tile, kk);
  }
};

// ---- the kernel ----

template <class L, bool MASK, bool LSE, int NWG>
__global__ void __launch_bounds__(Shape<NWG>::THREADS, 1)
    flash_fwd_sm90_kernel(const Params p) {
  using S = Shape<NWG>;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // Q full, K/V full, K/V empty
  // tiles on a 1024-byte boundary: the swizzle atoms are aligned
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_tile = base;
  auto k_tile = [&](int st) { return base + S::Q_BYTES + TILE_BYTES * 2 * st; };
  auto v_tile = [&](int st) { return base + S::Q_BYTES + TILE_BYTES * (2 * st + 1); };
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t q_full = bar0;
  auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (1 + STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0 loads, 1 .. NWG compute
  const int q0 = blockIdx.x * S::BM;
  const int bh = blockIdx.y;
  const int n_tiles = (p.kv_len + BN - 1) / BN;
  const typename L::Head h = L::head(p, bh);

  if (tid == 0) {
    mbar_init(q_full, 128);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);
      mbar_init(empty(st), NWG);  // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- loader: Q, then the K/V ring, as far ahead as the ring allows ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::LOAD_REGS));
    const typename L::Loader ld(tid, h.ld);
    ld.template load<S::BM>(q_tile, base_ptr, h.q, q0, p.q_len);
    L::signal(q_full);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      if (j >= STAGES) mbar_wait(empty(st), (j / STAGES - 1) & 1);
      ld.template load<BN>(k_tile(st), base_ptr + (k_tile(st) - base), h.k, j * BN, p.kv_len);
      ld.template load<BN>(v_tile(st), base_ptr + (v_tile(st) - base), h.v, j * BN, p.kv_len);
      L::signal(full(st));
    }
    cp_async_wait_all();  // no thread leaves with copies in flight
    return;
  }

  // ---- consumers: warpgroup c owns query rows 64 c .. 64 c + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::MMA_REGS));
  const int c = wg - 1;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = 16 * warp + lane / 4, qd = lane % 4;  // rows g, g + 8 of the 64
  const int row0 = q0 + 64 * c + g, row1 = row0 + 8;  // query indices
  const uint32_t q_half = q_tile + c * HALF_BYTES;
  // named barriers 1 .. NWG pass the turn around the ring
  const int my_turn = 1 + c, next_turn = 1 + (c + 1) % NWG;
  const float sc = MASK ? 1.f : p.scale_log2;  // masked scores are scaled first
  // mask rows of this thread's two queries (rows past q_len read none)
  const bool live0 = row0 < p.q_len, live1 = row1 < p.q_len;
  const float* mrow0 = nullptr;
  const float* mrow1 = nullptr;
  if constexpr (MASK) {
    const float* mh =
        p.mask + (size_t)(bh / p.heads) * p.ms.b + (size_t)(bh % p.heads) * p.ms.h;
    mrow0 = mh + (size_t)(live0 ? row0 : 0) * p.ms.q;
    mrow1 = mh + (size_t)(live1 ? row1 : 0) * p.ms.q;
  }

  float s[64], o[32];
  uint32_t pa[32];  // P in bf16: eight A fragments of 16 keys
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f, pa[i] = 0u;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units

  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n128<L::TA_S, L::TB_S>(s, L::desc_q(q_half, kk), L::desc_k(k_tile(st), kk),
                                      kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_n64<L::TB_PV>(o, pa + 4 * kk, L::desc_v(v_tile(st), kk));
    wgmma_commit();
  };
  // S of key tile j -> P in place (f32); returns the rows' rescale factors.
  // s[i] holds row (i & 2 ? row1 : row0), key k0 + 8 (i >> 2) + 2 qd + (i & 1).
  // Maxima and sums run in four partial chains a row for instruction-level
  // parallelism.
  auto softmax = [&](int j, float& a0, float& a1) {
    const int k0 = j * BN;
    if constexpr (MASK) {
      // pointers to the mask at keys k0 + 8 n + 2 qd of both rows, stepped
      // eight keys at a time (opaque, so the 32 key offsets a row are not
      // all held in registers)
      const size_t mk = p.ms.k;
      const float* mp0 = mrow0 + (size_t)(k0 + 2 * qd) * mk;
      const float* mp1 = mrow1 + (size_t)(k0 + 2 * qd) * mk;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e, key = k0 + 8 * n + 2 * qd + (e & 1);
          const bool ok = ((e & 2) ? live1 : live0) && key < p.kv_len;
          const float* mp = ((e & 2) ? mp1 : mp0) + (e & 1) * mk;
          s[i] = s[i] * p.scale_log2 + (ok ? *mp * LOG2E : 0.f);
        }
        mp0 += 8 * mk;
        mp1 += 8 * mk;
        asm volatile("" : "+l"(mp0), "+l"(mp1)::"memory");
      }
    }
    if (k0 + BN > p.kv_len) {  // the ragged last tile
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i >> 2) + 2 * qd + (i & 1) >= p.kv_len) s[i] = -INFINITY;
    }
    float mx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {  // partial (i >> 3) & 3 of row (i >> 1) & 1
      float& m = mx[((i >> 1) & 1) * 4 + ((i >> 3) & 3)];
      m = fmaxf(m, s[i]);
    }
    float mx0 = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    float mx1 = fmaxf(fmaxf(mx[4], mx[5]), fmaxf(mx[6], mx[7]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // a row sits in a lane quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0 * sc), n1 = fmaxf(m1, mx1 * sc);
    const float ref0 = n0 == -INFINITY ? 0.f : n0, ref1 = n1 == -INFINITY ? 0.f : n1;
    a0 = ex2(m0 - ref0);
    a1 = ex2(m1 - ref1);
    m0 = n0;
    m1 = n1;
    float sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], sc, r ? -ref1 : -ref0));
      sum[r * 4 + ((i >> 3) & 3)] += s[i];
    }
    l0 = l0 * a0 + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    l1 = l1 * a1 + ((sum[4] + sum[5]) + (sum[6] + sum[7]));
  };
  auto release = [&](int st) {
    if (t == 0) mbar_arrive(empty(st));
  };

  if (c == NWG - 1) bar_arrive(1, 256);  // warpgroup 0 issues first
  mbar_wait(q_full, 0);

  // turn 0: S_0
  mbar_wait(full(0), 0);
  fence_async_shared();
  bar_sync(my_turn, 256);
  wgmma_fence();
  issue_s(0);
  bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(s);
  float a0, a1;
  softmax(0, a0, a1);
  to_a(pa, s);

  // turn j: S_j and O += P_{j-1} V_{j-1}, then the softmax of S_j
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % STAGES, prev = (j - 1) % STAGES;
    mbar_wait(full(st), (j / STAGES) & 1);
    fence_async_shared();
    bar_sync(my_turn, 256);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_s(st);
    issue_pv(prev);
    bar_arrive(next_turn, 256);
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    fence_regs(s);
    softmax(j, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(prev);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? a1 : a0;
    to_a(pa, s);
  }

  // last turn: O += P_{n-1} V_{n-1}; the last warpgroup's hand-over has no
  // taker
  bar_sync(my_turn, 256);
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  issue_pv((n_tiles - 1) % STAGES);
  if (c != NWG - 1) bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  release((n_tiles - 1) % STAGES);

  // ---- epilogue ----
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  if constexpr (LSE) {
    if (qd == 0) {
      const float ln2 = 0.6931471805599453f;
      if (live0)
        p.lse[(size_t)bh * p.q_len + row0] = m0 == -INFINITY ? -1e30f : m0 * ln2 + logf(l0);
      if (live1)
        p.lse[(size_t)bh * p.q_len + row1] = m1 == -INFINITY ? -1e30f : m1 * ln2 + logf(l1);
    }
  }
  // O through this warpgroup's own Q tile, which no product reads any more
  char* half = base_ptr + c * HALF_BYTES;
  L::stage(half, o, g, qd, 1.f / l0, 1.f / l1);
  bar_sync(1 + NWG + c, 128);
  L::store(h.o, h.ld, half, q0 + 64 * c, p.q_len, t);
}

// Launch for (q tiles, b * h); unmasked calls take three consumer
// warpgroups, masked ones two (see the design note above).
template <class L, bool MASK, bool LSE>
cudaError_t launch(const Params& p, int bh, cudaStream_t st) {
  constexpr int NWG = MASK ? 2 : 3;
  using S = Shape<NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<L, MASK, LSE, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.q_len + S::BM - 1) / S::BM, bh);
  flash_fwd_sm90_kernel<L, MASK, LSE, NWG><<<grid, S::THREADS, S::SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90

}  // namespace flash

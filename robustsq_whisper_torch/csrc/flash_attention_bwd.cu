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
// deterministic: `flash_attention_bwd_dq` runs one block per (query tile,
// b * h) over the key tiles; `flash_attention_bwd_dkv` one block per (key
// tile, b * h) over the query tiles. Rows of lse and delta past q_len are
// taken as 0 and their P as 0 (P is 0 on keys past kv_len too), and Q / dO
// rows past q_len and K / V rows past kv_len load as 0, so the
// zero-weighted products of a ragged tail stay finite (the TPU kernels
// sanitise those rows for the same reason).
//
// Bound on the card: operations. A head takes 2 * T^2 * 64 tensor-core
// operations a product: dQ does three (S, dP, dS K; 6 * bh * T^2 * 64 = 113
// GFLOP at the Whisper-medium training shape, b * h = 128, T = 1516: 0.114
// ms at 989 TFLOP/s), dK/dV four (S^T, dP^T, P^T dO, dS^T Q; 151 GFLOP,
// 0.152 ms). Each also takes one exp2 a score on the special-function unit
// (2.9e8 a call, about 0.07 ms), which has to run under the products.
//
// The bf16 design, on the forward's machinery (sm90.cuh; flash_fwd_sm90.cuh):
// - Warpgroup 0 loads: cp.async into 128-byte-swizzled tiles, each thread's
//   copies arriving on a stage's "full" mbarrier; consumers free a stage on
//   its "empty" mbarrier. NWG consumer warpgroups of 64 rows run every
//   product as wgmma (m64n64k16, f32 accumulation); the loader gives them
//   its registers with setmaxnreg.
// - dQ: a block loads the Q and dO rows of 64 * NWG queries once and streams
//   64-key K/V stages through a ring of DQ_STAGES. Per key tile a consumer
//   computes S = Q K^T and dP = dO V^T (both operands K-major from shared
//   memory), P and dS in registers, and dQ += dS K with dS as the register
//   A operand and K read N-major. NWG = 3 (192 queries; 40 registers a
//   loader thread, 152 a consumer thread), 2 when masked (56 / 224).
// - dK/dV: a block loads the K and V rows of 128 keys once (two consumers)
//   and streams 64-query stages of Q, dO, lse and delta. A consumer computes
//   S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in the
//   accumulator layout, which is the register-A layout of dV += P^T dO and
//   dK += dS^T Q (dO and Q read N-major). 40 / 232 registers.
// - The consumers take turns on the tensor cores (named barriers in a
//   ring): a turn issues tile j's two score products and tile j - 1's
//   gradient products back to back, hands over, and computes P_j and dS_j
//   while the next consumer's products run. A stage is freed only after the
//   products that read it have completed.
// - Each K/V tile of dQ serves 64 * NWG queries and each Q/dO stage of
//   dK/dV 128 keys, so the streamed operand is read from L2 once for every
//   192 (128) rows of a head rather than every 64.
// - The per-score work between the products does not all hide under the
//   other consumers' products, so it is kept to four instructions a score:
//   an FFMA to the log2-scaled exponent, the EX2, and P (dP - delta) as an
//   FADD and an FMUL. The 1 / sqrt(64) = 2^-3 of dS is applied to dQ and
//   dK in the epilogue (a power of two: the same bf16 bits), and rows or
//   keys past the lengths are zeroed only on the tiles that hold them
//   (through a -inf mask term where there is a mask).
// - P and dS are rounded to bf16 before their products, as the TPU's
//   default-precision dot rounds them; exponentials are ex2.approx.ftz on
//   log2-scaled scores, as in the forward. The epilogue stages each 64 x 64
//   result in the consumer's own swizzled Q (dQ) or K and V (dK/dV) rows and
//   stores it with 16-byte words.
//
// f32 inputs (the tests' exact path) run SIMT kernels: one thread per query
// (dQ) or per key (dK/dV).

#include "sm90.cuh"

using namespace flash;
using namespace flash::sm90;

namespace {

// ---- bf16: Hopper ----

constexpr int BK = 64;           // keys (dQ) or queries (dK/dV) a streamed stage
constexpr int DQ_STAGES = 8;     // K/V stages of the dQ ring
constexpr int DKV_STAGES = 8;    // Q/dO stages of the dK/dV ring
constexpr int STAT_BYTES = 512;  // 64 lse then 64 delta, f32, a dK/dV stage

// bf16 tensors for the Hopper kernels (the f32 launches read them as f32)
struct Params {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;  // (b * h, q_len)
  const float* mask;         // read at MaskStrides when MASK
  __nv_bfloat16 *dq, *dk, *dv;
  int heads, q_len, kv_len;
  MaskStrides ms;
  float scale, scale_log2;
};

// dQ: NWG consumer warpgroups of 64 queries
template <int NWG>
struct DqShape {
  static constexpr int BM = 64 * NWG;             // queries a block
  static constexpr int THREADS = 128 * (NWG + 1);  // the loader, then the consumers
  static constexpr int ROWS_BYTES = BM * HD * 2;   // the block's Q (or dO) rows
  static constexpr int SMEM_BYTES = 2 * ROWS_BYTES + DQ_STAGES * 2 * HALF_BYTES + 1024;
  // registers a thread after setmaxnreg (the launch gives 128 or 168); at
  // the forward's 32 this loader, which keeps four head pointers, spills
  static constexpr int LOAD_REGS = NWG == 2 ? 56 : 40;
  static constexpr int MMA_REGS = NWG == 2 ? 224 : 152;
  static_assert(128 * LOAD_REGS + 128 * NWG * MMA_REGS <= 65536, "register file");
};

// dK/dV: two consumer warpgroups of 64 keys
struct DkvShape {
  static constexpr int NWG = 2;
  static constexpr int BM = 64 * NWG;  // keys a block
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int ROWS_BYTES = BM * HD * 2;  // the block's K (or V) rows
  static constexpr int SMEM_BYTES =
      2 * ROWS_BYTES + DKV_STAGES * (2 * HALF_BYTES + STAT_BYTES) + 1024;
  // the launch gives each of the 384 threads 168 registers
  static constexpr int LOAD_REGS = 40;
  static constexpr int MMA_REGS = 232;
  static_assert(128 * LOAD_REGS + 128 * NWG * MMA_REGS <= 65536, "register file");
};

__device__ __forceinline__ void init_ring(uint64_t* bars, int stages, int nwg) {
  const uint32_t bar0 = smem_addr(bars);
  mbar_init(bar0, 128);  // the block's own rows
  for (int st = 0; st < stages; ++st) {
    mbar_init(bar0 + 8 * (1 + st), 128);              // full: every loader thread
    mbar_init(bar0 + 8 * (1 + stages + st), nwg);     // empty: a thread a consumer
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

template <bool MASK, int NWG>
__global__ void __launch_bounds__(DqShape<NWG>::THREADS, 1)
    flash_bwd_dq_sm90_kernel(const Params p) {
  using S = DqShape<NWG>;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * DQ_STAGES];  // Q/dO full, K/V full, empty
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_tile = base, do_tile = base + S::ROWS_BYTES;
  auto k_tile = [&](int st) { return base + 2 * S::ROWS_BYTES + 2 * HALF_BYTES * st; };
  auto v_tile = [&](int st) { return k_tile(st) + HALF_BYTES; };
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t rows_full = bar0;
  auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (1 + DQ_STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0 loads, 1 .. NWG compute
  const int q0 = blockIdx.x * S::BM;
  const int bh = blockIdx.y, bi = bh / p.heads, hi = bh % p.heads;
  const int ld = p.heads * HD;
  const size_t qo = (size_t)bi * p.q_len * ld + hi * HD;
  const size_t ko = (size_t)bi * p.kv_len * ld + hi * HD;
  const int n_tiles = (p.kv_len + BK - 1) / BK;

  if (tid == 0) init_ring(bars, DQ_STAGES, NWG);
  __syncthreads();

  if (wg == 0) {
    // ---- loader: Q and dO, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::LOAD_REGS));
    const RowTiles::Loader l(tid, ld);
    l.load<S::BM>(q_tile, nullptr, p.q + qo, q0, p.q_len);
    l.load<S::BM>(do_tile, nullptr, p.dout + qo, q0, p.q_len);
    cp_async_arrive(rows_full);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % DQ_STAGES;
      if (j >= DQ_STAGES) mbar_wait(empty(st), (j / DQ_STAGES - 1) & 1);
      l.load<BK>(k_tile(st), nullptr, p.k + ko, j * BK, p.kv_len);
      l.load<BK>(v_tile(st), nullptr, p.v + ko, j * BK, p.kv_len);
      cp_async_arrive(full(st));
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
  const bool live0 = row0 < p.q_len, live1 = row1 < p.q_len;
  const uint32_t q_half = q_tile + c * HALF_BYTES, do_half = do_tile + c * HALF_BYTES;
  // named barriers 1 .. NWG pass the turn around the ring
  const int my_turn = 1 + c, next_turn = 1 + (c + 1) % NWG;
  // the rows' lse in log2 units and delta, 0 past q_len
  const float* lse = p.lse + (size_t)bh * p.q_len;
  const float* delta = p.delta + (size_t)bh * p.q_len;
  const float l0 = live0 ? lse[row0] * LOG2E : 0.f, l1 = live1 ? lse[row1] * LOG2E : 0.f;
  const float d0 = live0 ? delta[row0] : 0.f, d1 = live1 ? delta[row1] : 0.f;
  const float* mrow0 = nullptr;
  const float* mrow1 = nullptr;
  if constexpr (MASK) {
    const float* mh = p.mask + (size_t)bi * p.ms.b + (size_t)hi * p.ms.h;
    mrow0 = mh + (size_t)(live0 ? row0 : 0) * p.ms.q;
    mrow1 = mh + (size_t)(live1 ? row1 : 0) * p.ms.q;
  }

  float s[32], dp[32], dq[32];
  uint32_t dsa[16];  // dS in bf16: four A fragments of 16 keys
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dsa[i] = 0u;

  auto issue_scores = [&](int st) {  // S = Q K_j^T, dP = dO V_j^T
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64<0, 0>(s, RowTiles::desc_rows(q_half, kk),
                         RowTiles::desc_rows(k_tile(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64<0, 0>(dp, RowTiles::desc_rows(do_half, kk),
                         RowTiles::desc_rows(v_tile(st), kk), kk > 0);
    wgmma_commit();
  };
  auto issue_dq = [&](int st) {  // dQ += dS K_j
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_n64<1>(dq, dsa + 4 * kk, RowTiles::desc_cols(k_tile(st), kk));
    wgmma_commit();
  };
  // S, dP of key tile j -> dS / scale in s (f32; the epilogue applies the
  // scale to dQ: a power of two, so every rounding is as of dS itself).
  // s[i], dp[i]: row (i & 2 ? row1 : row0), key k0 + 8 (i >> 2) + 2 qd + (i & 1).
  auto grad_scores = [&](int j) {
    const int k0 = j * BK;
    if constexpr (MASK) {
      // pointers to the mask at keys k0 + 8 n + 2 qd of both rows, stepped
      // eight keys at a time (opaque, so the key offsets are not all held in
      // registers)
      const size_t mk = p.ms.k;
      const float* mp0 = mrow0 + (size_t)(k0 + 2 * qd) * mk;
      const float* mp1 = mrow1 + (size_t)(k0 + 2 * qd) * mk;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e, key = k0 + 8 * n + 2 * qd + (e & 1);
          const bool ok = ((e & 2) ? live1 : live0) && key < p.kv_len;
          const float* mp = ((e & 2) ? mp1 : mp0) + (e & 1) * mk;
          s[i] = s[i] * p.scale_log2 + (ok ? *mp * LOG2E : -INFINITY);  // P = 0 off the rows
        }
        mp0 += 8 * mk;
        mp1 += 8 * mk;
        asm volatile("" : "+l"(mp0), "+l"(mp1)::"memory");
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool r = i & 2;
      const float l = r ? l1 : l0;
      const float pr = ex2(MASK ? s[i] - l : fmaf(s[i], p.scale_log2, -l));
      s[i] = pr * (dp[i] - (r ? d1 : d0));
    }
    if (!MASK && (k0 + BK > p.kv_len || !(live0 && live1))) {  // P = 0 past q_len, kv_len
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!((i & 2) ? live1 : live0) || k0 + 8 * (i >> 2) + 2 * qd + (i & 1) >= p.kv_len)
          s[i] = 0.f;
    }
  };
  auto release = [&](int st) {
    if (t == 0) mbar_arrive(empty(st));
  };

  if (c == NWG - 1) bar_arrive(1, 256);  // warpgroup 0 issues first
  mbar_wait(rows_full, 0);

  // turn 0: S_0, dP_0, then dS_0
  mbar_wait(full(0), 0);
  fence_async_shared();
  bar_sync(my_turn, 256);
  wgmma_fence();
  issue_scores(0);
  bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad_scores(0);
  to_a(dsa, s);

  // turn j: S_j, dP_j and dQ += dS_{j-1} K_{j-1}, then dS_j
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % DQ_STAGES, prev = (j - 1) % DQ_STAGES;
    mbar_wait(full(st), (j / DQ_STAGES) & 1);
    fence_async_shared();
    bar_sync(my_turn, 256);
    fence_regs(dq);
    fence_regs(dsa);
    wgmma_fence();
    issue_scores(st);
    issue_dq(prev);
    bar_arrive(next_turn, 256);
    wgmma_wait<1>();  // S_j and dP_j are in; dS_{j-1} K_{j-1} may still run
    fence_regs(s);
    fence_regs(dp);
    grad_scores(j);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsa);
    release(prev);
    to_a(dsa, s);
  }

  // last turn: dQ += dS_{n-1} K_{n-1}; the last warpgroup's hand-over has
  // no taker
  bar_sync(my_turn, 256);
  fence_regs(dq);
  fence_regs(dsa);
  wgmma_fence();
  issue_dq((n_tiles - 1) % DQ_STAGES);
  if (c != NWG - 1) bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(dsa);
  release((n_tiles - 1) % DQ_STAGES);

  // ---- epilogue: dQ through this warpgroup's own Q rows, read no more ----
  char* half = base_ptr + c * HALF_BYTES;
  RowTiles::stage(half, dq, g, qd, p.scale, p.scale);
  bar_sync(1 + NWG + c, 128);
  RowTiles::store(p.dq + qo, ld, half, q0 + 64 * c, p.q_len, t);
}

template <bool MASK>
__global__ void __launch_bounds__(DkvShape::THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const Params p) {
  using S = DkvShape;
  constexpr int NWG = S::NWG;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * DKV_STAGES];  // K/V full, Q/dO full, empty
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  char* const base_ptr = smem_raw + (base - raw);
  const uint32_t k_tile = base, v_tile = base + S::ROWS_BYTES;
  auto q_tile = [&](int st) { return base + 2 * S::ROWS_BYTES + 2 * HALF_BYTES * st; };
  auto do_tile = [&](int st) { return q_tile(st) + HALF_BYTES; };
  // lse, then delta, of a stage's 64 queries
  constexpr int STATS = 2 * S::ROWS_BYTES + DKV_STAGES * 2 * HALF_BYTES;
  auto stats = [&](int st) { return base + STATS + STAT_BYTES * st; };
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t rows_full = bar0;
  auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (1 + DKV_STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0 loads, 1 .. NWG compute
  const int k0 = blockIdx.x * S::BM;
  const int bh = blockIdx.y, bi = bh / p.heads, hi = bh % p.heads;
  const int ld = p.heads * HD;
  const size_t qo = (size_t)bi * p.q_len * ld + hi * HD;
  const size_t ko = (size_t)bi * p.kv_len * ld + hi * HD;
  const int n_tiles = (p.q_len + BK - 1) / BK;

  if (tid == 0) init_ring(bars, DKV_STAGES, NWG);
  __syncthreads();

  if (wg == 0) {
    // ---- loader: K and V, then the ring of Q, dO, lse and delta ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::LOAD_REGS));
    const RowTiles::Loader l(tid, ld);
    l.load<S::BM>(k_tile, nullptr, p.k + ko, k0, p.kv_len);
    l.load<S::BM>(v_tile, nullptr, p.v + ko, k0, p.kv_len);
    cp_async_arrive(rows_full);
    // threads 0 .. 63 move one lse word a stage, 64 .. 127 one delta word
    // (4-byte words: a row of lse starts 4-byte aligned for odd q_len)
    const float* stat = (tid < 64 ? p.lse : p.delta) + (size_t)bh * p.q_len + (tid & 63);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % DKV_STAGES;
      if (j >= DKV_STAGES) mbar_wait(empty(st), (j / DKV_STAGES - 1) & 1);
      l.load<BK>(q_tile(st), nullptr, p.q + qo, j * BK, p.q_len);
      l.load<BK>(do_tile(st), nullptr, p.dout + qo, j * BK, p.q_len);
      const bool ok = j * BK + (tid & 63) < p.q_len;
      cp_async<4>(stats(st) + 4 * tid, ok ? stat + j * BK : stat, ok ? 4 : 0);
      cp_async_arrive(full(st));
    }
    cp_async_wait_all();  // no thread leaves with copies in flight
    return;
  }

  // ---- consumers: warpgroup c owns key rows 64 c .. 64 c + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::MMA_REGS));
  const int c = wg - 1;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = 16 * warp + lane / 4, qd = lane % 4;  // rows g, g + 8 of the 64
  const int key0 = k0 + 64 * c + g, key1 = key0 + 8;
  const bool live0 = key0 < p.kv_len, live1 = key1 < p.kv_len;
  const uint32_t k_half = k_tile + c * HALF_BYTES, v_half = v_tile + c * HALF_BYTES;
  const int my_turn = 1 + c, next_turn = 1 + (c + 1) % NWG;
  const float* mcol0 = nullptr;
  const float* mcol1 = nullptr;
  if constexpr (MASK) {
    const float* mh = p.mask + (size_t)bi * p.ms.b + (size_t)hi * p.ms.h;
    mcol0 = mh + (size_t)(live0 ? key0 : 0) * p.ms.k;
    mcol1 = mh + (size_t)(live1 ? key1 : 0) * p.ms.k;
  }

  float s[32], dp[32], dk[32], dv[32];  // s, dp: S^T and dP^T, then P^T and dS^T
  uint32_t pa[16], dsa[16];             // P^T and dS^T in bf16, A fragments of 16 queries
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = dsa[i] = 0u;

  auto issue_scores = [&](int st) {  // S^T = K Q_j^T, dP^T = V dO_j^T
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64<0, 0>(s, RowTiles::desc_rows(k_half, kk),
                         RowTiles::desc_rows(q_tile(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64<0, 0>(dp, RowTiles::desc_rows(v_half, kk),
                         RowTiles::desc_rows(do_tile(st), kk), kk > 0);
    wgmma_commit();
  };
  auto issue_dkv = [&](int st) {  // dV += P^T dO_j, dK += dS^T Q_j
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_n64<1>(dv, pa + 4 * kk, RowTiles::desc_cols(do_tile(st), kk));
      wgmma_rs_n64<1>(dk, dsa + 4 * kk, RowTiles::desc_cols(q_tile(st), kk));
    }
    wgmma_commit();
  };
  // S^T, dP^T of query tile j -> P^T in s, dS^T / scale in dp (f32; the
  // epilogue applies the scale to dK). s[i], dp[i]: key (i & 2 ? key1 :
  // key0), query q0 + 8 (i >> 2) + 2 qd + (i & 1).
  auto grad_scores = [&](int j, int st) {
    const int q0 = j * BK;
    if constexpr (MASK) {
      const size_t mq = p.ms.q;
      const float* mp0 = mcol0 + (size_t)(q0 + 2 * qd) * mq;
      const float* mp1 = mcol1 + (size_t)(q0 + 2 * qd) * mq;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e, query = q0 + 8 * n + 2 * qd + (e & 1);
          const bool ok = ((e & 2) ? live1 : live0) && query < p.q_len;
          const float* mp = ((e & 2) ? mp1 : mp0) + (e & 1) * mq;
          s[i] = s[i] * p.scale_log2 + (ok ? *mp * LOG2E : -INFINITY);  // P = 0 off the rows
        }
        mp0 += 8 * mq;
        mp1 += 8 * mq;
        asm volatile("" : "+l"(mp0), "+l"(mp1)::"memory");
      }
    }
    const float* ls = reinterpret_cast<const float*>(base_ptr + (stats(st) - base));
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * qd);
      const float2 dq2 = *reinterpret_cast<const float2*>(ls + 64 + 8 * n + 2 * qd);
      const float la = lq.x * LOG2E, lb = lq.y * LOG2E;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        const float l = (e & 1) ? lb : la;
        s[i] = ex2(MASK ? s[i] - l : fmaf(s[i], p.scale_log2, -l));
        dp[i] = s[i] * (dp[i] - ((e & 1) ? dq2.y : dq2.x));
      }
    }
    if (!MASK && (q0 + BK > p.q_len || !(live0 && live1))) {  // P = 0 past q_len, kv_len
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!((i & 2) ? live1 : live0) || q0 + 8 * (i >> 2) + 2 * qd + (i & 1) >= p.q_len)
          s[i] = dp[i] = 0.f;
    }
  };
  auto release = [&](int st) {
    if (t == 0) mbar_arrive(empty(st));
  };

  if (c == NWG - 1) bar_arrive(1, 256);  // warpgroup 0 issues first
  mbar_wait(rows_full, 0);

  // turn 0: S^T_0, dP^T_0, then P^T_0 and dS^T_0
  mbar_wait(full(0), 0);
  fence_async_shared();
  bar_sync(my_turn, 256);
  wgmma_fence();
  issue_scores(0);
  bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad_scores(0, 0);
  to_a(pa, s);
  to_a(dsa, dp);

  // turn j: S^T_j, dP^T_j and the gradients of tile j - 1, then P^T_j, dS^T_j
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % DKV_STAGES, prev = (j - 1) % DKV_STAGES;
    mbar_wait(full(st), (j / DKV_STAGES) & 1);
    fence_async_shared();
    bar_sync(my_turn, 256);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    issue_scores(st);
    issue_dkv(prev);
    bar_arrive(next_turn, 256);
    wgmma_wait<1>();  // S^T_j and dP^T_j are in; tile j - 1's products may still run
    fence_regs(s);
    fence_regs(dp);
    grad_scores(j, st);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(dsa);
    release(prev);
    to_a(pa, s);
    to_a(dsa, dp);
  }

  // last turn: the gradients of tile n - 1
  bar_sync(my_turn, 256);
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(dsa);
  wgmma_fence();
  issue_dkv((n_tiles - 1) % DKV_STAGES);
  if (c != NWG - 1) bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  release((n_tiles - 1) % DKV_STAGES);

  // ---- epilogue: dK and dV through this warpgroup's own K and V rows ----
  char* kh = base_ptr + c * HALF_BYTES;
  char* vh = base_ptr + S::ROWS_BYTES + c * HALF_BYTES;
  RowTiles::stage(kh, dk, g, qd, p.scale, p.scale);
  RowTiles::stage(vh, dv, g, qd, 1.f, 1.f);
  bar_sync(1 + NWG + c, 128);
  RowTiles::store(p.dk + ko, ld, kh, k0 + 64 * c, p.kv_len, t);
  RowTiles::store(p.dv + ko, ld, vh, k0 + 64 * c, p.kv_len, t);
}

// Launch for (query blocks, b * h); unmasked calls take three consumer
// warpgroups, masked ones two (the mask reads need the registers).
template <bool MASK>
cudaError_t launch_dq_sm90(const Params& p, int bh, cudaStream_t st) {
  constexpr int NWG = MASK ? 2 : 3;
  using S = DqShape<NWG>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<MASK, NWG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.q_len + S::BM - 1) / S::BM, bh);
  flash_bwd_dq_sm90_kernel<MASK, NWG><<<grid, S::THREADS, S::SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

// Launch for (key blocks, b * h).
template <bool MASK>
cudaError_t launch_dkv_sm90(const Params& p, int bh, cudaStream_t st) {
  using S = DkvShape;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<MASK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.kv_len + S::BM - 1) / S::BM, bh);
  flash_bwd_dkv_sm90_kernel<MASK><<<grid, S::THREADS, S::SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
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

// Either dtype's kernel: the Hopper kernels for bf16, the SIMT ones (which
// read the same pointers as f32) for f32.
template <bool MASK>
cudaError_t launch_dq(const Params& p, int bh, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dq_sm90<MASK>(p, bh, st);
  const dim3 grid((p.q_len + BT - 1) / BT, bh);
  flash_bwd_dq_f32_kernel<MASK><<<grid, BT, 0, st>>>(
      (const float*)p.q, (const float*)p.k, (const float*)p.v, (const float*)p.dout,
      p.lse, p.delta, p.mask, (float*)p.dq, p.heads, p.q_len, p.kv_len, p.ms, p.scale,
      p.scale_log2);
  return cudaGetLastError();
}

template <bool MASK>
cudaError_t launch_dkv(const Params& p, int bh, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dkv_sm90<MASK>(p, bh, st);
  const dim3 grid((p.kv_len + BT - 1) / BT, bh);
  flash_bwd_dkv_f32_kernel<MASK><<<grid, BT, 0, st>>>(
      (const float*)p.q, (const float*)p.k, (const float*)p.v, (const float*)p.dout,
      p.lse, p.delta, p.mask, (float*)p.dk, (float*)p.dv, p.heads, p.q_len, p.kv_len,
      p.ms, p.scale, p.scale_log2);
  return cudaGetLastError();
}

bool make_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* mask, void* dq, void* dk,
                 void* dv, int batch, int heads, int q_len, int kv_len, int head_dim,
                 int smb, int smh, int smq, int smk, int dtype) {
  using B = __nv_bfloat16;
  const float scale = 1.f / sqrtf((float)head_dim);
  p = Params{(const B*)q, (const B*)k, (const B*)v, (const B*)dout, (const float*)lse,
             (const float*)delta, (const float*)mask, (B*)dq, (B*)dk, (B*)dv, heads, q_len,
             kv_len, MaskStrides{smb, smh, smq, smk}, scale, scale * LOG2E};
  const int bh = batch * heads;
  return head_dim == HD && q_len > 0 && kv_len > 0 && bh > 0 && bh <= 65535 &&
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
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, batch, heads,
                   q_len, kv_len, head_dim, smb, smh, smq, smk, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mask) return (int)launch_dq<true>(p, batch * heads, dtype, st);
  return (int)launch_dq<false>(p, batch * heads, dtype, st);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* mask, void* dk,
                                       void* dv, int batch, int heads, int q_len,
                                       int kv_len, int head_dim, int smb, int smh,
                                       int smq, int smk, int dtype, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, mask, nullptr, dk, dv, batch, heads, q_len,
                   kv_len, head_dim, smb, smh, smq, smk, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mask) return (int)launch_dkv<true>(p, batch * heads, dtype, st);
  return (int)launch_dkv<false>(p, batch * heads, dtype, st);
}

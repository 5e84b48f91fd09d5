// Hopper building blocks shared by the flash-attention kernels
// (flash_fwd_sm90.cuh, flash_attention_bwd.cu; decode_cross_attention.cu
// takes its cp.async wrappers, self_cache_read.cuh its exp2, w8a8_matmul.cu
// the s8 wgmma, TMA and mbarrier wrappers): PTX wrappers for mbarriers,
// named barriers, cp.async, TMA and wgmma (bf16 and s8), the 128-byte
// swizzle and its wgmma descriptors, and the row-major tiles (128-byte rows
// of 64 bf16 channels, a row every heads * 64 elements) that a loader
// warpgroup moves into shared memory and a consumer warpgroup writes back.

#pragma once

#include "flash_common.cuh"

namespace flash {

namespace sm90 {

constexpr int HALF_BYTES = 64 * HD * 2;  // 64 swizzled 128-byte rows

// ---- PTX helpers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` more of asynchronous (TMA) copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// global -> shared, W bytes; src_bytes 0 writes zeros and reads nothing
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(W), "r"(src_bytes)
                 : "memory");
}

// arrive on `bar` once every earlier cp.async of this thread has landed (one
// of the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// TMA: the box at (c0, c1) (innermost coordinate first) of the tensor map
// at `tmap` (a __grid_constant__ kernel parameter) into shared memory at
// dst, completing its bytes on `bar`; parts of the box outside the tensor
// are written as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// close this thread's current group of cp.async copies
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// After an mbarrier wait: shared memory written through the generic proxy
// (cp.async, st.shared) becomes visible to this thread's wgmma reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows under the 128-byte swizzle (8-row atoms, 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to registers that an in-flight
// wgmma reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) (+)= A (smem, 64 x 16) B (smem, 16 x 128); TA, TB: the
// transpose bits (1 = M- or N-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) (+)= A (smem, 64 x 16) B (smem, 16 x 64)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) += A (registers, 64 x 16 bf16) B (smem, 16 x 64)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d (64 x 128, s32) (+)= A (smem, 64 x 32 s8) B (smem, 32 x 128 s8). Integer
// wgmma takes both operands K-major only (no transpose bits); the sums are
// exact (s32, wrapping)
__device__ __forceinline__ void wgmma_s8_ss_n128(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A 64 x N f32 accumulator (N = 8 * NR / 4), rounded to bf16, as the
// register A operands of a product over its columns: a[4 kk .. 4 kk + 3]
// hold columns 16 kk .. 16 kk + 15. The m64nN accumulator layout is the
// register-A layout, so this is a packing of neighbours.
template <int NR>
__device__ __forceinline__ void to_a(uint32_t (&a)[NR / 2], const float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// ---- row-major tiles ----
//
// (b, T, heads, 64) with rows heads * 64 elements apart. A tile is N time
// rows of 64 channels, one swizzled 128-byte row each.
struct RowTiles {
  __device__ __forceinline__ static void signal(uint32_t bar) { cp_async_arrive(bar); }

  // A loader thread (tid in [0, 128)) moves 16-byte chunk ch of rows r0 +
  // 16 k; the shared-memory offsets are one base plus 2048 k.
  struct Loader {
    uint32_t soff;
    int r0;
    size_t goff;
    int ld;

    __device__ __forceinline__ Loader(int tid, int ld_) : ld(ld_) {
      r0 = tid >> 3;
      const int ch = tid & 7;
      soff = swz(r0, ch);
      goff = (size_t)r0 * ld + ch * 8;
    }

    // rows [t0, t0 + N) into the tile at dst, zeros at or past n
    template <int N>
    __device__ __forceinline__ void load(uint32_t dst, char*, const __nv_bfloat16* src, int t0,
                                         int n) const {
      const __nv_bfloat16* g = src + (size_t)t0 * ld + goff;
#pragma unroll
      for (int k = 0; k < N / 16; ++k) {
        const bool ok = t0 + r0 + 16 * k < n;
        cp_async<16>(dst + soff + 2048 * k, ok ? g + (size_t)16 * k * ld : src, ok ? 16 : 0);
      }
    }
  };

  // The 64 rows at `tile` as an operand over channels 16 kk .. 16 kk + 15
  // (K-major: A of X Y^T, or its B)
  __device__ __forceinline__ static uint64_t desc_rows(uint32_t tile, int kk) {
    return desc(tile + kk * 32, 16, 1024);
  }
  // The rows at `tile` as the B operand of a product over rows 16 kk .. 16
  // kk + 15 (N-major: Y of X Y, 64 channels wide)
  __device__ __forceinline__ static uint64_t desc_cols(uint32_t tile, int kk) {
    return desc(tile + kk * 2048, HALF_BYTES, 1024);
  }

  // o[i]: row r0 or r0 + 8 (i & 2), channel 8 (i >> 2) + 2 qd + (i & 1),
  // times inv0 or inv1, into a 64-row tile
  __device__ __forceinline__ static void stage(char* half, const float (&o)[32], int r0,
                                               int qd, float inv0, float inv1) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = 8 * (i >> 2) + 2 * qd, r = r0 + ((i & 2) ? 8 : 0);
      const float s = (i & 2) ? inv1 : inv0;
      *reinterpret_cast<__nv_bfloat162*>(half + swz(r, c >> 3) + (c & 7) * 2) =
          __floats2bfloat162_rn(o[i] * s, o[i + 1] * s);
    }
  }
  // a staged 64-row tile to device rows [q0, q0 + 64), those below n
  __device__ __forceinline__ static void store(__nv_bfloat16* dst, int ld, const char* half,
                                               int q0, int n, int tid) {
#pragma unroll
    for (int i = tid; i < 64 * 8; i += 128) {
      const int r = i >> 3, ch = i & 7;
      if (q0 + r < n)
        *reinterpret_cast<uint4*>(dst + (size_t)(q0 + r) * ld + ch * 8) =
            *reinterpret_cast<const uint4*>(half + swz(r, ch));
    }
  }
};

}  // namespace sm90

}  // namespace flash

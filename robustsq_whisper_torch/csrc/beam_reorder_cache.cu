// Beam reorder of the decode cache: the flat cache in place, every other
// leaf out of place with its dead tail zero-filled.
//
// Replaces the TPU kernel `_permute4d_kernel` (JAX package,
// ops/beam_gather.py, entry `beam_reorder_cache`, 4-D leaves): for every
// leaf and layer, out[:, i, :P] = x[:, src[i], :P] over the cache's
// (layers, rows, T_pad, n_state) layout, with P the live positions rounded
// up to whole 8-position chunks (the wrapper computes it). Positions >= P
// are left as they were: the TPU output aliases its input and dead chunks
// never run.
//
// Bound on the card: bytes. Each live (layer, row, position) payload is
// read once and written once; there is no arithmetic.
//
// Design (first version): an in-place row permute on a GPU races when one
// block writes row j before another has read it as some src[i] = j. Here
// one block owns one (leaf, layer, position, byte slice) tile for ALL rows:
// it stages the tile of every row in shared memory, syncs, and writes each
// row back from its source row's copy. Tiles of different blocks are
// disjoint, so no block can see another's writes, and no second buffer is
// needed. The slice is the row's whole payload (n_state * element size
// bytes) halved until the tile of all rows fits 96 KB, so two blocks share
// an SM. The data is moved as 16-byte words whatever its type: bf16, int8
// and f32 leaves are the same bytes to this kernel. Both K and V leaves
// ride one launch.
//
// Entry `beam_reorder_cache_flat` replaces the TPU kernel `_permute_kernel`
// (the flattened route of the same JAX entry, for leaves that are not
// (layers, rows, T % 8, n_state % 128): the 5-D cache and its f32 scale
// leaves). Each leaf's row payload is seen as bytes; out of place (the TPU
// call is not aliased), out[l, i, :live] = x[l, src[i], :live] and
// out[l, i, live:] = 0, written without reading x there. The wrapper
// computes `live` from the TPU kernel's rule (whole chunks of 32 rows of
// 128 elements, at least one). Bound: bytes, the live bytes read plus every
// byte written. One thread moves 16-byte words of one (leaf, layer, row);
// there is no race, since no output aliases an input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_TARGET = 96 * 1024;   // bytes of shared memory a block
constexpr int TILE_MAX = 227 * 1024;     // Hopper's per-block limit

__global__ void __launch_bounds__(THREADS)
    reorder_kernel(const int* __restrict__ src, char* x0, char* x1,
                   int layers, int rows, long long row_stride, int row_bytes,
                   int slice_bytes) {
  extern __shared__ uint4 tile[];  // rows * slice_bytes
  const int slice = blockIdx.x, t = blockIdx.y;
  const int leaf = blockIdx.z / layers, layer = blockIdx.z % layers;
  char* base = (leaf ? x1 : x0) + (long long)layer * rows * row_stride +
               (long long)t * row_bytes + (long long)slice * slice_bytes;
  const int vecs = slice_bytes / 16;
  const int total = rows * vecs;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / vecs, c = i - r * vecs;
    tile[i] = *reinterpret_cast<const uint4*>(base + r * row_stride + 16 * c);
  }
  __syncthreads();  // every row of the tile is read before any is written
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / vecs, c = i - r * vecs;
    *reinterpret_cast<uint4*>(base + r * row_stride + 16 * c) =
        tile[__ldg(src + r) * vecs + c];
  }
}

constexpr int WORDS_PER_THREAD = 4;

__global__ void __launch_bounds__(THREADS)
    reorder_flat_kernel(const int* __restrict__ src,
                        const uint4* __restrict__ x0,
                        const uint4* __restrict__ x1, uint4* __restrict__ o0,
                        uint4* __restrict__ o1, int layers, int rows,
                        long long row_words, long long live_words) {
  const int row = blockIdx.y;
  const int leaf = blockIdx.z / layers, layer = blockIdx.z % layers;
  const uint4* x = leaf ? x1 : x0;
  uint4* o = leaf ? o1 : o0;
  const long long base = (long long)layer * rows;
  const uint4* in = x + (base + __ldg(src + row)) * row_words;
  uint4* out = o + (base + row) * row_words;
  const long long w0 = (long long)blockIdx.x * THREADS * WORDS_PER_THREAD;
#pragma unroll
  for (int k = 0; k < WORDS_PER_THREAD; ++k) {
    const long long w = w0 + k * THREADS + threadIdx.x;
    if (w < live_words) {
      out[w] = in[w];
    } else if (w < row_words) {
      out[w] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

}  // namespace

// src: (rows,) device int32, each in [0, rows). x0 (and x1 when leaves is
// 2): (layers, rows, t_pad, row_bytes) contiguous bytes, 16-byte aligned.
// Reorders positions [0, positions) of every row in place. Returns
// cudaGetLastError() after the launch.
extern "C" int beam_reorder_cache(const void* src, void* x0, void* x1,
                                  int leaves, int layers, int rows, int t_pad,
                                  int row_bytes, int positions, void* stream) {
  if (leaves < 1 || leaves > 2 || (leaves == 2 && x1 == nullptr) ||
      layers <= 0 || rows <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      positions <= 0 || positions > t_pad || positions > 65535 ||
      (long long)leaves * layers > 65535)
    return (int)cudaErrorInvalidValue;
  int slice = row_bytes;
  while ((long long)rows * slice > TILE_TARGET && slice % 32 == 0) slice /= 2;
  const long long smem = (long long)rows * slice;
  if (smem > TILE_MAX) return (int)cudaErrorInvalidValue;
  // past the 48 KB default: opt in once, never during a graph capture
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        reorder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_MAX);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid(row_bytes / slice, positions, leaves * layers);
  reorder_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int*)src, (char*)x0, (char*)x1, layers, rows,
      (long long)t_pad * row_bytes, row_bytes, slice);
  return (int)cudaGetLastError();
}

// src: (rows,) device int32, each in [0, rows). x0 (and x1 when leaves is
// 2): (layers, rows, row_bytes) contiguous, 16-byte aligned; o0 (o1): fresh
// outputs of the same shape. Writes out[l, i, :live_bytes] = x[l, src[i],
// :live_bytes] and zeros over the rest of each row. Returns
// cudaGetLastError() after the launch.
extern "C" int beam_reorder_cache_flat(const void* src, const void* x0,
                                       const void* x1, void* o0, void* o1,
                                       int leaves, int layers, int rows,
                                       int row_bytes, int live_bytes,
                                       void* stream) {
  if (leaves < 1 || leaves > 2 ||
      (leaves == 2 && (x1 == nullptr || o1 == nullptr)) || layers <= 0 ||
      rows <= 0 || rows > 65535 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      live_bytes <= 0 || live_bytes > row_bytes || live_bytes % 16 != 0 ||
      (long long)leaves * layers > 65535)
    return (int)cudaErrorInvalidValue;
  const long long words = row_bytes / 16;
  const long long per_block = (long long)THREADS * WORDS_PER_THREAD;
  const dim3 grid((unsigned)((words + per_block - 1) / per_block), rows,
                  leaves * layers);
  reorder_flat_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const uint4*)x0, (const uint4*)x1, (uint4*)o0,
      (uint4*)o1, layers, rows, words, live_bytes / 16);
  return (int)cudaGetLastError();
}

// Beam reorder of the flat decode cache, in place.
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

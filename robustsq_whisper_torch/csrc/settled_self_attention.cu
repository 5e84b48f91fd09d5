// Online-softmax state over the settled cache prefix, read through a
// per-row indirection (the deferred beam reorder).
//
// Replaces the TPU kernel `_settled_kernel` (JAX package,
// ops/self_attention.py, entry `settled_self_attention`): for each logical
// row i and head, the unnormalised state (m, l, acc) of q_i's attention
// over positions [0, settled) of PHYSICAL cache row row_map[i] in layer
// slab `layer_idx` of the flat (layers, rows_phys, T_pad, n_state) cache:
// m = max score, l = sum exp(s - m), acc = sum exp(s - m) v, all f32. The
// caller merges it with the window's and the new token's states. With
// settled == 0 no position is read and the state is (-1e30, 0, 0); its
// weight in the merge is exactly 0, as that of the TPU kernel's one
// all-masked group is.
//
// The read, its bound on the card and its design are those of
// self_cache_read.cuh (mode SETTLED): each CTA reads row_map[i] once, and
// on the card the indirection is only a pointer offset.

#include "self_cache_read.cuh"

using namespace self_read;

// q: (rows, n_state); k_cache, v_cache: (layers, rows_phys, t_pad,
// n_state), n_state = heads * head_dim, all contiguous and 16-byte
// aligned, dtype 0 = f32, 1 = bf16. layer_idx, settled: device int32
// scalars; row_map: (rows,) device int32, each in [0, rows_phys). m, l:
// (rows, heads) f32; acc: (rows, n_state) f32. Returns the launch's
// error.
extern "C" int settled_self_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* layer_idx, const void* settled,
                                      const void* row_map, void* m, void* l, void* acc,
                                      int rows, int rows_phys, int heads, int head_dim,
                                      int t_pad, int dtype, void* stream) {
  if (rows_phys <= 0) return (int)cudaErrorInvalidValue;
  const Params p{q, nullptr, nullptr, k_cache, v_cache, nullptr, (const int*)layer_idx,
                 (const int*)settled, (const int*)row_map, nullptr, (float*)m, (float*)l,
                 (float*)acc, rows_phys, heads, t_pad};
  if (dtype == 0) return launch<float, float, SETTLED>(p, rows, head_dim, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, SETTLED>(p, rows, head_dim, stream);
  return (int)cudaErrorInvalidValue;
}

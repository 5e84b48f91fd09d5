// One-query self attention over the flat decode cache, dense or int8.
//
// Replaces the TPU kernel `_kernel` (JAX package, ops/self_attention.py,
// entry `decode_self_attention`): for each batch row and head,
// softmax([q . K_cache[0, pos); q . k_new] / sqrt(d)) over [V_cache[0,
// pos); v_new], with the cache stored flat as (layers, batch, T_pad,
// n_state) and the layer's slab picked by `layer_idx`. The new token's K/V
// are separate operands and merge last, as on the TPU.
//
// The int8 cache (the TPU kernel's `quantized` branch, entry
// `decode_self_attention_int8`) holds int8 K and V and one bf16 (layers,
// batch, T_pad, 128) scale leaf: per (position, head), K's scale in lane
// `head` and V's in lane `heads + head`. The K scale multiplies the score
// after the dot; the V scale multiplies the softmax weight before the V
// sum, while the normaliser l sums the raw weights. The new token's K/V are
// exact and merge last.
//
// The read, its bound on the card and its design are those of
// self_cache_read.cuh (mode DECODE). pos == 0 is legal: no cache position
// is read and the output is exactly v_new.

#include "self_cache_read.cuh"

using namespace self_read;

// q, k_new, v_new, out: (batch, n_state); k_cache, v_cache: (layers, batch,
// t_pad, n_state), n_state = heads * head_dim, all contiguous and 16-byte
// aligned, dtype 0 = f32, 1 = bf16. layer_idx, pos: device int32 scalars.
// Returns the launch's error.
extern "C" int decode_self_attention(const void* q, const void* k_new, const void* v_new,
                                     const void* k_cache, const void* v_cache,
                                     const void* layer_idx, const void* pos, void* out,
                                     int batch, int heads, int head_dim, int t_pad, int dtype,
                                     void* stream) {
  const Params p{q, k_new, v_new, k_cache, v_cache, nullptr, (const int*)layer_idx,
                 (const int*)pos, nullptr, out, nullptr, nullptr, nullptr, batch, heads, t_pad};
  if (dtype == 0) return launch<float, float, DECODE>(p, batch, head_dim, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, DECODE>(p, batch, head_dim, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 cache: k8, v8 int8 (layers, batch, t_pad, n_state), scales bf16
// (layers, batch, t_pad, 128) with K's scale of head h in lane h and V's in
// lane heads + h (2 heads <= 128). q, k_new, v_new and out as above,
// dtype 0 = f32, 1 = bf16.
extern "C" int decode_self_attention_int8(const void* q, const void* k_new, const void* v_new,
                                          const void* k8, const void* v8, const void* scales,
                                          const void* layer_idx, const void* pos, void* out,
                                          int batch, int heads, int head_dim, int t_pad,
                                          int dtype, void* stream) {
  if (2 * heads > 128) return (int)cudaErrorInvalidValue;
  const Params p{q, k_new, v_new, k8, v8, (const __nv_bfloat16*)scales,
                 (const int*)layer_idx, (const int*)pos, nullptr, out, nullptr, nullptr,
                 nullptr, batch, heads, t_pad};
  if (dtype == 0) return launch<float, int8_t, DECODE>(p, batch, head_dim, stream);
  if (dtype == 1) return launch<__nv_bfloat16, int8_t, DECODE>(p, batch, head_dim, stream);
  return (int)cudaErrorInvalidValue;
}

"""One-query self attention over the dense flat decode cache.

``decode_self_attention`` launches the hand-written CUDA kernel
(``csrc/decode_self_attention.cu``) for CUDA tensors and runs the plain
version for CPU tensors. The contract is the JAX package's
``decode_self_attention`` with the two-leaf dense cache: the cache is
(layers, batch, T_pad, n_state) with heads concatenated along n_state,
positions [0, pos) of slab ``layer_idx`` are live, and the new token's K/V
(not yet in the cache) merge last.
"""

from __future__ import annotations

import torch

from . import _build

BLOCK_POS = 8  # the cache length is padded to a multiple of this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_self_attention_plain(
    q: torch.Tensor,  # (batch, n_state), unscaled
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache: tuple,
    pos,
    layer_idx,
    heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (batch, n_state) in q.dtype."""
    k_flat, v_flat = cache
    b, n_state = q.shape
    hd = n_state // heads
    p, li = int(pos), int(layer_idx)
    heads_of = lambda t: t.float().reshape(*t.shape[:-1], heads, hd)
    qh = heads_of(q) * hd**-0.5  # (b, h, hd)
    kc = heads_of(k_flat[li, :, :p])  # (b, p, h, hd)
    vc = heads_of(v_flat[li, :, :p])
    s = torch.cat(
        [
            torch.einsum("bhd,bphd->bhp", qh, kc),
            torch.einsum("bhd,bhd->bh", qh, heads_of(k_new))[..., None],
        ],
        dim=-1,
    )
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhp,bphd->bhd", w[..., :p], vc) + w[..., p:] * heads_of(
        v_new
    )
    return o.reshape(b, n_state).to(q.dtype)


def decode_self_attention(
    q: torch.Tensor,  # (batch, n_state) current query, head-concatenated
    k_new: torch.Tensor,  # (batch, n_state) current token K (not cached)
    v_new: torch.Tensor,
    cache: tuple,  # (k_flat, v_flat): (layers, batch, T_pad, n_state)
    pos,  # int32 scalar: cache positions [0, pos) are live
    layer_idx,  # int32 scalar: layer slab to read
    heads: int,
) -> torch.Tensor:
    """softmax([q.K_cache[:pos]; q.k_new] / sqrt(hd)) @ [V_cache; v_new];
    returns (batch, n_state) in q.dtype."""
    cache = tuple(cache)
    if len(cache) == 3:
        raise NotImplementedError(
            "the int8 flat self cache (three leaves) is ROADMAP queue B: "
            "decode_self_attention int8 branch"
        )
    k_flat, v_flat = cache
    b, n_state = q.shape
    if k_flat.dim() != 4 or k_flat.shape != v_flat.shape:
        raise ValueError(f"bad flat cache shapes {k_flat.shape}, {v_flat.shape}")
    if k_flat.shape[1] != b or k_flat.shape[3] != n_state or n_state % heads:
        raise ValueError(f"cache {k_flat.shape} does not match q {q.shape}")
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("q, k_new, v_new must share a (batch, n_state) shape")
    if q.device.type == "cpu":
        return decode_self_attention_plain(
            q, k_new, v_new, cache, pos, layer_idx, heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = (q, k_new, v_new, k_flat, v_flat)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k/v and the cache must all be f32 or bf16")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("q, k/v and the cache must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError("q, k/v and the cache must be contiguous")
    hd = n_state // heads
    if hd != 64:
        raise ValueError(f"the kernel takes head_dim 64, got {hd}")
    p = _build.device_scalar(pos, q.device)
    li = _build.device_scalar(layer_idx, q.device)
    out = torch.empty_like(q)
    err = _build.load("decode_self_attention")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_flat.data_ptr(),
        v_flat.data_ptr(), li.data_ptr(), p.data_ptr(), out.data_ptr(),
        b, heads, hd, k_flat.shape[2], _DTYPES[q.dtype],
        _build.stream_ptr(q.device),
    )
    _build.check(err, "decode_self_attention")
    decode_self_attention.launches += 1
    return out


decode_self_attention.launches = 0

"""One-query self attention over the flat and time-minor decode caches.

``decode_self_attention`` launches the hand-written CUDA kernel
(``csrc/decode_self_attention.cu``) for CUDA tensors and runs the plain
version for CPU tensors. The contract is the JAX package's
``decode_self_attention``: the cache is (layers, batch, T_pad, n_state)
with heads concatenated along n_state, positions [0, pos) of slab
``layer_idx`` are live, and the new token's K/V (not yet in the cache)
merge last. The cache is the dense two-leaf form, or the int8 three-leaf
form of ``quantize_flat_kv``: int8 K and V and one bf16 (layers, batch,
T_pad, 128) scale leaf, K's per-head scales in lanes [0, heads) and V's in
[heads, 2 heads). The K scale multiplies each score after the dot, the V
scale each softmax weight before the V sum, while the normaliser sums the
raw weights.

``decode_self_attention_tmin`` reads the time-minor (layers, batch, heads,
head_dim, T_pad) cache through ``decode_cross_attention`` with
``return_state`` and merges the new token in f32, as the JAX package
composes it; it has no kernel of its own.

The deferred beam reorder reads the cache in three parts, as the JAX
package does: ``settled_self_attention`` (the kernel
``csrc/settled_self_attention.cu``, plain version beside it) gives the
online-softmax state over the settled prefix read through a per-row
indirection; ``window_attention_state`` and ``new_token_state`` give the
states of the logically ordered window and of the new token, and
``merge_attention_states`` combines them. Those three are plain PyTorch,
as they are plain XLA in JAX; ``deferred_self_attention`` composes all.

Both kernels are one read of the flat cache (``csrc/self_cache_read.cuh``):
one CTA a (row, head), or for the int8 cache a pair of heads, over tiles
of ``SELF_TILE`` positions, each tile one round trip. The cache and q,
k_new and v_new must be 16-byte aligned.
"""

from __future__ import annotations

import torch

from . import _build
from .decode_attention import decode_cross_attention

BLOCK_POS = 8  # the cache length is padded to a multiple of this
NEG = -1e30  # the JAX package's mask value for online-softmax states
SELF_TILE = 64  # positions a CTA of the self-cache read takes a round trip
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(tensors, what: str) -> None:
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError(f"{what} must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def quantize_flat_kv(k: torch.Tensor, v: torch.Tensor, heads: int):
    """Flat K/V rows (..., n_state) -> the int8 cache form (k8, v8,
    scales): int8 data of the input shape and one (..., 128) bf16 scale
    leaf, symmetric per (row, head), K's scales in lanes [0, heads), V's in
    [heads, 2 heads), zeros after. The scale is rounded to bf16 before the
    divide, and the codes are clipped to +-127 (the rounding may shrink
    the scale below max / 127)."""
    if 2 * heads > 128:
        raise ValueError(f"{heads} heads do not fit two scales a head in 128 lanes")

    def one(x):
        g = x.float().reshape(*x.shape[:-1], heads, -1)
        # the floor as a scalar: no host-to-device copy, so a CUDA graph can
        # capture the step
        s = torch.clamp((g.abs().amax(dim=-1) / 127.0).to(torch.bfloat16), min=1e-6)
        q8 = torch.clamp(torch.round(g / s[..., None].float()), -127, 127)
        return q8.to(torch.int8).reshape(x.shape), s

    k8, ks = one(k)
    v8, vs = one(v)
    pad = torch.zeros(
        (*ks.shape[:-1], 128 - 2 * heads), dtype=torch.bfloat16, device=k.device
    )
    return k8, v8, torch.cat([ks, vs, pad], dim=-1)


def decode_self_attention_plain(
    q: torch.Tensor,  # (batch, n_state), unscaled
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache: tuple,
    pos,
    layer_idx,
    heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, both cache forms: (batch,
    n_state) in q.dtype."""
    b, n_state = q.shape
    hd = n_state // heads
    p, li = int(pos), int(layer_idx)
    heads_of = lambda t: t.float().reshape(*t.shape[:-1], heads, hd)
    qh = heads_of(q) * hd**-0.5  # (b, h, hd)
    kc = heads_of(cache[0][li, :, :p])  # (b, p, h, hd)
    vc = heads_of(cache[1][li, :, :p])
    s_cache = torch.einsum("bhd,bphd->bhp", qh, kc)
    if len(cache) == 3:  # int8 codes: fold the per-(position, head) scales
        sc = cache[2][li, :, :p].float()  # (b, p, 128)
        s_cache = s_cache * sc[..., :heads].transpose(1, 2)
    s = torch.cat(
        [s_cache, torch.einsum("bhd,bhd->bh", qh, heads_of(k_new))[..., None]],
        dim=-1,
    )
    w = torch.softmax(s, dim=-1)
    w_cache = w[..., :p]
    if len(cache) == 3:
        w_cache = w_cache * sc[..., heads:2 * heads].transpose(1, 2)
    o = torch.einsum("bhp,bphd->bhd", w_cache, vc) + w[..., p:] * heads_of(v_new)
    return o.reshape(b, n_state).to(q.dtype)


def decode_self_attention(
    q: torch.Tensor,  # (batch, n_state) current query, head-concatenated
    k_new: torch.Tensor,  # (batch, n_state) current token K (not cached)
    v_new: torch.Tensor,
    cache: tuple,  # (k_flat, v_flat[, scales]): (layers, batch, T_pad, n_state)
    pos,  # int32 scalar: cache positions [0, pos) are live
    layer_idx,  # int32 scalar: layer slab to read
    heads: int,
) -> torch.Tensor:
    """softmax([q.K_cache[:pos]; q.k_new] / sqrt(hd)) @ [V_cache; v_new];
    returns (batch, n_state) in q.dtype. Launches are counted in
    ``launches`` (dense cache) and ``int8_launches`` (int8 cache)."""
    cache = tuple(cache)
    if len(cache) not in (2, 3):
        raise ValueError(f"a flat cache has 2 or 3 leaves, got {len(cache)}")
    quantized = len(cache) == 3
    k_flat, v_flat = cache[:2]
    b, n_state = q.shape
    if k_flat.dim() != 4 or k_flat.shape != v_flat.shape:
        raise ValueError(f"bad flat cache shapes {k_flat.shape}, {v_flat.shape}")
    if k_flat.shape[1] != b or k_flat.shape[3] != n_state or n_state % heads:
        raise ValueError(f"cache {k_flat.shape} does not match q {q.shape}")
    if quantized and (
        k_flat.dtype != torch.int8 or v_flat.dtype != torch.int8
        or cache[2].shape != (*k_flat.shape[:3], 128)
        or cache[2].dtype != torch.bfloat16
    ):
        raise ValueError(
            "the int8 flat cache is int8 K/V and a bf16 (layers, batch, T, "
            "128) scale leaf"
        )
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("q, k_new, v_new must share a (batch, n_state) shape")
    if q.device.type == "cpu":
        return decode_self_attention_plain(
            q, k_new, v_new, cache, pos, layer_idx, heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = (q, k_new, v_new) + cache
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors[1:3]) or (
        not quantized and any(t.dtype != q.dtype for t in cache)
    ):
        raise TypeError("q, k/v and a dense cache must all be f32 or bf16")
    _check_operands(tensors, "q, k/v and the cache")
    hd = n_state // heads
    if hd != 64:
        raise ValueError(f"the kernel takes head_dim 64, got {hd}")
    p = _build.device_scalar(pos, q.device)
    li = _build.device_scalar(layer_idx, q.device)
    out = torch.empty_like(q)
    lib = "decode_self_attention"
    if quantized:
        err = _build.load(lib, "decode_self_attention_int8")(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_flat.data_ptr(),
            v_flat.data_ptr(), cache[2].data_ptr(), li.data_ptr(), p.data_ptr(),
            out.data_ptr(), b, heads, hd, k_flat.shape[2], _DTYPES[q.dtype],
            _build.stream_ptr(q.device),
        )
        _build.check(err, "decode_self_attention_int8")
        decode_self_attention.int8_launches += 1
        return out
    err = _build.load(lib)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_flat.data_ptr(),
        v_flat.data_ptr(), li.data_ptr(), p.data_ptr(), out.data_ptr(),
        b, heads, hd, k_flat.shape[2], _DTYPES[q.dtype],
        _build.stream_ptr(q.device),
    )
    _build.check(err, "decode_self_attention")
    decode_self_attention.launches += 1
    return out


decode_self_attention.launches = 0
decode_self_attention.int8_launches = 0


def decode_self_attention_tmin(
    q3: torch.Tensor,  # (batch, heads, head_dim) current query, unscaled
    k_new: torch.Tensor,  # (batch, heads, head_dim) current token K (not cached)
    v_new: torch.Tensor,
    cache: tuple,  # (k, v): (layers, batch, heads, head_dim, T_pad)
    pos,  # int32 scalar: cache positions [0, pos) are live
    layer_idx,  # int32 scalar: layer slab to read
) -> torch.Tensor:
    """Self attention over the time-minor cache: the cache part is
    ``decode_cross_attention`` with ``return_state`` (its kernel on the
    card), the new token merges here in f32. Returns (batch, heads,
    head_dim) in q3.dtype."""
    kc, vc = cache
    o, m, l = decode_cross_attention(
        q3, kc, vc, kv_len=pos, layer_idx=layer_idx, return_state=True
    )  # o (b, h, d) f32 normalised; m, l (b, h) f32
    d = q3.shape[-1]
    qf = q3.float() * d**-0.5
    s_new = (qf * k_new.float()).sum(dim=-1)  # (b, h)
    m_fin = torch.maximum(m, s_new)
    lw = torch.exp(m - m_fin) * l  # the cache part's reweighted normaliser
    p_new = torch.exp(s_new - m_fin)
    den = torch.clamp(lw + p_new, min=1e-30)[..., None]
    out = (o * lw[..., None] + p_new[..., None] * v_new.float()) / den
    return out.to(q3.dtype)


def settled_self_attention_plain(
    q: torch.Tensor,  # (rows, n_state), unscaled
    cache: tuple,
    settled,
    layer_idx,
    row_map: torch.Tensor,
    heads: int,
):
    """Plain PyTorch version of the kernel: (m, l, acc) as f32."""
    k_flat, v_flat = cache
    rows, n_state = q.shape
    hd = n_state // heads
    s_n, li = int(settled), int(layer_idx)
    rm = row_map.long()
    heads_of = lambda t: t.float().reshape(*t.shape[:-1], heads, hd)
    qh = heads_of(q) * hd**-0.5  # (rows, h, hd)
    kc = heads_of(k_flat[li].index_select(0, rm)[:, :s_n])  # (rows, s, h, hd)
    vc = heads_of(v_flat[li].index_select(0, rm)[:, :s_n])
    s = torch.einsum("rhd,rphd->rph", qh, kc)
    m = torch.full((rows, heads), NEG, dtype=torch.float32, device=q.device)
    if s_n:
        m = torch.maximum(m, s.amax(dim=1))
    p = torch.exp(s - m[:, None])
    acc = torch.einsum("rph,rphd->rhd", p, vc).reshape(rows, n_state)
    return m, p.sum(dim=1), acc


def settled_self_attention(
    q: torch.Tensor,  # (rows, n_state) current query, head-concatenated
    cache: tuple,  # (k_flat, v_flat): the dense flat cache
    settled,  # int32 scalar: positions [0, settled) are settled
    layer_idx,  # int32 scalar: layer slab to read
    row_map: torch.Tensor,  # (rows,) physical cache row of each logical row
    heads: int,
):
    """Online-softmax state of each logical row's attention over the
    settled prefix [0, settled) of physical row ``row_map[i]``: (m, l, acc),
    (rows, heads) f32 twice and (rows, n_state) f32, unnormalised. With
    ``settled == 0`` the state is (-1e30, 0, 0), which weighs exactly 0 in
    ``merge_attention_states`` (the JAX kernel's one all-masked group
    returns other l and acc of the same zero weight)."""
    k_flat, v_flat = cache
    rows, n_state = q.shape
    if k_flat.dim() != 4 or k_flat.shape != v_flat.shape:
        raise ValueError(f"bad flat cache shapes {k_flat.shape}, {v_flat.shape}")
    if k_flat.shape[3] != n_state or n_state % heads:
        raise ValueError(f"cache {k_flat.shape} does not match q {q.shape}")
    if row_map.shape != (rows,):
        raise ValueError(f"row_map {tuple(row_map.shape)} for {rows} rows")
    if q.device.type == "cpu":
        return settled_self_attention_plain(
            q, cache, settled, layer_idx, row_map, heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in cache):
        raise TypeError("q and the cache must all be f32 or bf16")
    if row_map.device != q.device:
        raise ValueError("q, row_map and the cache must be on one device")
    _check_operands((q, k_flat, v_flat), "q and the cache")
    hd = n_state // heads
    if hd != 64:
        raise ValueError(f"the kernel takes head_dim 64, got {hd}")
    st = _build.device_scalar(settled, q.device)
    li = _build.device_scalar(layer_idx, q.device)
    rm = row_map.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    m, l = torch.empty((rows, heads), **f32), torch.empty((rows, heads), **f32)
    acc = torch.empty((rows, n_state), **f32)
    err = _build.load("settled_self_attention")(
        q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), li.data_ptr(),
        st.data_ptr(), rm.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), rows, k_flat.shape[1], heads, hd, k_flat.shape[2],
        _DTYPES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(err, "settled_self_attention")
    settled_self_attention.launches += 1
    return m, l, acc


settled_self_attention.launches = 0


def merge_attention_states(states: list, heads: int) -> torch.Tensor:
    """Combine online-softmax states [(m, l, acc), ...] pairwise; returns
    the normalised (rows, n_state) output in f32."""
    m, l, acc = states[0]
    hd = acc.shape[-1] // heads
    expand = lambda x: x.repeat_interleave(hd, dim=-1)
    for m2, l2, acc2 in states[1:]:
        m_new = torch.maximum(m, m2)
        a1 = torch.exp(m - m_new)
        a2 = torch.exp(m2 - m_new)
        l = l * a1 + l2 * a2
        acc = acc * expand(a1) + acc2 * expand(a2)
        m = m_new
    return acc / expand(torch.clamp(l, min=1e-30))


def window_attention_state(
    q: torch.Tensor,  # (rows, n_state), unscaled
    k_win: torch.Tensor,  # (rows, W, n_state) logical window K
    v_win: torch.Tensor,
    count,  # int32 scalar: window positions [0, count) are live
    heads: int,
):
    """Online-softmax state over the logically ordered reorder window."""
    rows, w, n_state = k_win.shape
    hd = n_state // heads
    qf = q.float().reshape(rows, heads, hd) * hd**-0.5
    kf = k_win.float().reshape(rows, w, heads, hd)
    s = torch.einsum("rhd,rwhd->rwh", qf, kf)
    live = torch.arange(w, device=q.device)[None, :, None] < count
    s = torch.where(live, s, torch.full_like(s, NEG))
    m = s.amax(dim=1)
    p = torch.exp(s - m[:, None])
    vf = v_win.float().reshape(rows, w, heads, hd)
    acc = torch.einsum("rwh,rwhd->rhd", p, vf).reshape(rows, n_state)
    return m, p.sum(dim=1), acc


def new_token_state(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, heads: int
):
    """Online-softmax state of the current token (not yet cached)."""
    rows, n_state = q.shape
    hd = n_state // heads
    qf = q.float().reshape(rows, heads, hd) * hd**-0.5
    s = (qf * k_new.float().reshape(rows, heads, hd)).sum(dim=-1)
    return s, torch.ones_like(s), v_new.float().reshape(rows, n_state)


def deferred_self_attention(
    q: torch.Tensor,  # (rows, n_state)
    k_new: torch.Tensor,  # (rows, n_state)
    v_new: torch.Tensor,
    cache: tuple,  # (k_flat, v_flat): the dense flat cache
    pos,  # int32 scalar: positions [0, pos) are filled
    settled,  # int32 scalar: [0, settled) in flush order, the rest window
    row_map: torch.Tensor,  # (rows,) physical row of each logical prefix
    layer_idx,
    heads: int,
    window: int,  # the flush period R: the window's capacity
) -> torch.Tensor:
    """Self attention under the deferred beam reorder: the settled prefix
    through the row-indirected kernel, the <= ``window`` most recent
    positions (kept logically ordered by the per-step mini-reorder) and the
    current token, merged exactly. Returns (rows, n_state) in q.dtype."""
    if len(tuple(cache)) != 2:
        raise ValueError("deferred reorder needs the dense flat cache")
    k_flat, v_flat = cache
    layers, rows_phys, t_pad, n_state = k_flat.shape
    rows = q.shape[0]
    st = settled_self_attention(q, cache, settled, layer_idx, row_map, heads)
    # window slab [start, start + window) of logical rows, gathered with
    # device indices so the loop never reads a scalar back
    dev = q.device
    start = torch.clamp(torch.as_tensor(settled, device=dev), 0, t_pad - window)
    t_idx = start + torch.arange(window, device=dev)
    row0 = (torch.as_tensor(layer_idx, device=dev) * rows_phys
            + torch.arange(rows, device=dev))
    flat_idx = (row0[:, None] * t_pad + t_idx[None, :]).reshape(-1).long()
    kw, vw = (
        x.reshape(-1, n_state).index_select(0, flat_idx).reshape(rows, window, n_state)
        for x in (k_flat, v_flat)
    )
    win = window_attention_state(q, kw, vw, pos - settled, heads)
    new = new_token_state(q, k_new, v_new, heads)
    return merge_attention_states([st, win, new], heads).to(q.dtype)

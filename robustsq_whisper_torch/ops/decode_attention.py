"""One-query cross attention over quantized encoder K/V (the decode loop).

``decode_cross_attention`` launches the hand-written CUDA kernel
(``csrc/decode_cross_attention.cu``) for CUDA tensors and runs the plain
version for CPU tensors. The contract is the JAX package's
``decode_cross_attention``:

- K/V ride transposed as (batch, heads, d, T) or stacked per layer as
  (layers, batch, heads, d, T) with ``layer_idx`` choosing the slab;
- ``packed_int4`` stores two channels a byte along head_dim (``pack_int4``);
- q is scaled as ``(q * d**-0.5) * k_scale`` (inside the kernel on the
  card, in the same order); positions at or past ``kv_len`` are masked;
  ``v_scale`` multiplies the output and the caller adds the V zero-point;
- ``group > 1`` (beam search): q is (batch, heads, group, d), the group's
  beams share their utterance's K/V, one read for all of them, and the
  output is (batch, heads, group, d); the scales fold as in group 1, with
  ``k_scale[:, :, None]`` and ``v_scale[:, :, None]``;
- ``return_state`` (the time-minor self cache): no scales; the output is
  the normalised f32 attention and the online-softmax state (m, l), f32 of
  shape (batch, heads) (or (batch, heads, group)). A row with no live
  position returns m = -1e30 (the JAX package's ``NEG_INF``), l = 0 and a
  zero output, which weighs exactly 0 in a merge.

The kernel reads only positions [0, kv_len), what the JAX option
``dynamic_grid`` asks of the TPU kernel, so the port has no such option.

On the card one call with group <= 8 is one launch: the kernel reads q in
its own dtype through its strides (a transposed beam view needs no copy),
scales it and writes the output in q's dtype. It splits T across a
cluster of ``choose_splits`` CTAs, a pure function of the shapes.

The wrapper counts kernel launches with group 1 in ``launches``, those
with group > 1 in ``grouped_launches`` and those with ``return_state`` in
``state_launches``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_MODES = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}
PACKED_INT4_MODE = 0
TILE = {0: 128, 1: 128, 2: 64, 3: 64}  # positions a kernel tile holds, by mode
MAX_GROUP = 8  # queries one kernel CTA serves
MAX_SPLITS = 8  # CTAs along T in one cluster
NEG = -1e30  # m of a row with no live position (the JAX package's NEG_INF)


def choose_splits(pairs: int, t_pad: int, mode: int, sms: int) -> int:
    """CTAs along T for each of ``pairs`` (batch, head) pairs: as many as
    keep the CTAs at or under one an SM (a second CTA on an SM only
    shares its issue slots), at most ``MAX_SPLITS``, and at least two of
    T_pad's tiles a CTA (a cluster costs more to launch and merge than a
    tile's work), then cut to the fewest that keep the same tiles a CTA
    (no rank left empty when every position is live). 1 where the pairs
    alone fill the card or T_pad holds fewer than four tiles."""
    tiles = -(-t_pad // TILE[mode])
    s = max(1, min(MAX_SPLITS, tiles // 2, sms // pairs))
    return -(-tiles // -(-tiles // s))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_int4(q4: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (ints in [-8, 7], axis -2 = head_dim, even length)
    two a byte along head_dim: byte (..., i, t) holds channel ``i`` in its
    low nibble and channel ``i + d/2`` in its high nibble. Returns int8 of
    shape (..., head_dim // 2, T)."""
    d = q4.shape[-2]
    if d % 2:
        raise ValueError(f"head_dim must be even, got {d}")
    v = q4.to(torch.int32)
    lo, hi = v[..., : d // 2, :], v[..., d // 2 :, :]
    byte = ((hi << 4) | (lo & 0xF)) & 0xFF
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: int32 in [-8, 7], head_dim restored on
    axis -2."""
    w = packed.to(torch.int32)  # sign-extended byte
    lo = ((w & 0xF) ^ 8) - 8  # sign-extended low nibble
    hi = w >> 4  # arithmetic shift: sign-extended high nibble
    return torch.cat([lo, hi], dim=-2)


def decode_cross_attention_plain(
    qs: torch.Tensor,  # (batch, heads, group, d) f32, already scaled
    kt: torch.Tensor,
    vt: torch.Tensor,
    kv_len,
    layer_idx=None,
    packed_int4: bool = False,
    return_state: bool = False,
):
    """Plain PyTorch version of the kernel: (batch, heads, group, d) f32,
    and with ``return_state`` also (m, l), each (batch, heads, group)."""
    if layer_idx is not None:
        kt, vt = kt[int(layer_idx)], vt[int(layer_idx)]
    if packed_int4:
        kt, vt = unpack_int4(kt), unpack_int4(vt)
    s = torch.einsum("bhgd,bhdt->bhgt", qs, kt.float())
    live = torch.arange(kt.shape[-1], device=qs.device) < torch.as_tensor(
        kv_len, device=qs.device
    )
    if not return_state:
        s = s.masked_fill(~live, float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgt,bhdt->bhgd", p, vt.float())
    m = s.masked_fill(~live, NEG).amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgt,bhdt->bhgd", p, vt.float())
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def decode_cross_attention(
    q: torch.Tensor,  # (batch, heads, head_dim); (b, heads, group, hd) if group > 1
    kt: torch.Tensor,  # ([layers,] batch, heads, head_dim[/2], T)
    vt: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # (batch, heads, head_dim)
    v_scale: Optional[torch.Tensor] = None,
    kv_len=None,  # int32 scalar: true length <= T
    layer_idx=None,  # int32 scalar: slab of stacked kt/vt
    packed_int4: bool = False,
    group: int = 1,  # beam queries per K/V row
    return_state: bool = False,  # f32 output and the state (m, l)
):
    """softmax(q . K / sqrt(d)) @ V for one query position; returns q's
    shape in q.dtype, or with ``return_state`` (f32 output, m, l)."""
    if group > 1:
        b, h, gq, d = q.shape
        if gq != group:
            raise ValueError(f"q {tuple(q.shape)} does not hold group {group}")
    else:
        b, h, d = q.shape
    if return_state and (k_scale is not None or v_scale is not None):
        raise ValueError(
            "return_state is for the dense (unscaled) self cache; fold scales "
            "outside after the merge instead"
        )
    stacked = kt.dim() == 5
    if stacked != (layer_idx is not None):
        raise ValueError("layer_idx is given exactly when kt/vt are stacked")
    if kt.shape != vt.shape or kt.shape[-2] != (d // 2 if packed_int4 else d):
        raise ValueError(f"bad K/V shapes {kt.shape}, {vt.shape} for d={d}")
    if tuple(kt.shape[-4:-2]) != (b, h):
        raise ValueError(f"K/V {kt.shape} do not match q {q.shape}")
    q4 = q if group > 1 else q[:, :, None]  # (b, h, g, d)
    if kv_len is None:
        kv_len = kt.shape[-1]

    if q.device.type == "cpu":
        qs = q4.float() * (d**-0.5)
        if k_scale is not None:
            qs = qs * k_scale.float()[:, :, None]
        res = decode_cross_attention_plain(
            qs, kt, vt, kv_len, layer_idx, packed_int4, return_state
        )
    elif q.device.type == "cuda":
        res = _launch(q4, kt, vt, kv_len, layer_idx, packed_int4, return_state, k_scale)
    else:
        raise ValueError(f"unsupported device {q.device}")
    squeeze = (lambda x: x) if group > 1 else (lambda x: x[:, :, 0])
    if return_state:
        return tuple(squeeze(x) for x in res)
    out = res.to(q.dtype)
    if v_scale is not None:
        out = (out.float() * v_scale.float()[:, :, None]).to(q.dtype)
    return squeeze(out)


def _launch(q4, kt, vt, kv_len, layer_idx, packed_int4, return_state=False, k_scale=None):
    """The kernel on (b, h, g, d) queries, unscaled, in their own dtype and
    strides: one launch for a group of up to ``MAX_GROUP``, several (each
    reading K/V once) for a wider one. Returns the output in q's dtype
    (bf16 or f32; f32 for another dtype), or the f32 output, m and l with
    ``return_state``."""
    dev = q4.device
    if packed_int4:
        if kt.dtype != torch.int8:
            raise TypeError("packed int4 K/V must be int8")
        mode = PACKED_INT4_MODE
    elif kt.dtype in _MODES:
        mode = _MODES[kt.dtype]
    else:
        raise TypeError(f"unsupported K/V dtype {kt.dtype}")
    if vt.dtype != kt.dtype:
        raise TypeError("K and V must share a dtype")
    for t in (kt, vt):
        if t.device != dev:
            raise ValueError("q and K/V must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K/V must be contiguous and 16-byte aligned")
    pad = (-kt.shape[-1] * kt.element_size()) % 16 // kt.element_size()
    if pad:  # the kernel copies 16-byte words of a row; masking covers the pad
        kt, vt = F.pad(kt, (0, pad)), F.pad(vt, (0, pad))
    t_pad = kt.shape[-1]
    if q4.dtype not in (torch.float32, torch.bfloat16):
        q4 = q4.float()
    if q4.stride(-1) != 1:
        q4 = q4.contiguous()
    if k_scale is not None:
        k_scale = k_scale.float().contiguous()
        if k_scale.device != dev or k_scale.shape != (*q4.shape[:2], q4.shape[3]):
            raise ValueError(f"k_scale {tuple(k_scale.shape)} does not fit q {tuple(q4.shape)}")
    kv = _build.device_scalar(kv_len, dev)
    li = None if layer_idx is None else _build.device_scalar(layer_idx, dev)
    b, h, group, d = q4.shape
    splits = choose_splits(b * h, t_pad, mode, _sm_count(dev.index or 0))
    out_dtype = torch.float32 if return_state else q4.dtype
    outs, ms, ls = [], [], []
    for g0 in range(0, group, MAX_GROUP):
        q_part = q4[:, :, g0:g0 + MAX_GROUP]
        g = q_part.shape[2]
        out = torch.empty((b, h, g, d), dtype=out_dtype, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        m, l = (torch.empty((b, h, g), **f32) for _ in range(2)) if return_state else (None, None)
        err = _build.load("decode_cross_attention")(
            q_part.data_ptr(), None if k_scale is None else k_scale.data_ptr(),
            kt.data_ptr(), vt.data_ptr(), None if li is None else li.data_ptr(),
            kv.data_ptr(), out.data_ptr(), None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(), b, h, d, t_pad, g, mode,
            int(q4.dtype == torch.bfloat16), *q_part.stride()[:3], splits,
            _build.stream_ptr(dev),
        )
        _build.check(err, "decode_cross_attention")
        if return_state:
            decode_cross_attention.state_launches += 1
        elif group > 1:
            decode_cross_attention.grouped_launches += 1
        else:
            decode_cross_attention.launches += 1
        outs.append(out)
        ms.append(m)
        ls.append(l)
    cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=2)
    if return_state:
        return cat(outs), cat(ms), cat(ls)
    return cat(outs)


decode_cross_attention.launches = 0
decode_cross_attention.grouped_launches = 0
decode_cross_attention.state_launches = 0

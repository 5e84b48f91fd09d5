"""One-query cross attention over quantized encoder K/V (the decode loop).

``decode_cross_attention`` launches the hand-written CUDA kernel
(``csrc/decode_cross_attention.cu``) for CUDA tensors and runs the plain
version for CPU tensors. The contract is the JAX package's
``decode_cross_attention``:

- K/V ride transposed as (batch, heads, d, T) or stacked per layer as
  (layers, batch, heads, d, T) with ``layer_idx`` choosing the slab;
- ``packed_int4`` stores two channels a byte along head_dim (``pack_int4``);
- q is scaled by ``d**-0.5 * k_scale`` here, outside the kernel; positions
  at or past ``kv_len`` are masked; ``v_scale`` multiplies the output and
  the caller adds the V zero-point;
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

The wrapper counts kernel launches with group 1 in ``launches``, those
with group > 1 in ``grouped_launches`` and those with ``return_state`` in
``state_launches``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_MODES = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}
PACKED_INT4_MODE = 0
MAX_GROUP = 8  # queries one kernel block serves
MAX_SCORES = 49152  # group * T_pad scores a block keeps in shared memory
NEG = -1e30  # m of a row with no live position (the JAX package's NEG_INF)


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
    qs = q4.float() * (d**-0.5)
    if k_scale is not None:
        qs = qs * k_scale.float()[:, :, None]
    if kv_len is None:
        kv_len = kt.shape[-1]

    if q.device.type == "cpu":
        res = decode_cross_attention_plain(
            qs, kt, vt, kv_len, layer_idx, packed_int4, return_state
        )
    elif q.device.type == "cuda":
        res = _launch(qs, kt, vt, kv_len, layer_idx, packed_int4, return_state)
    else:
        raise ValueError(f"unsupported device {q.device}")
    squeeze = (lambda x: x) if group > 1 else (lambda x: x[:, :, 0])
    if return_state:
        return tuple(squeeze(x) for x in res)
    out = res.to(q.dtype)
    if v_scale is not None:
        out = (out.float() * v_scale.float()[:, :, None]).to(q.dtype)
    return squeeze(out)


def _launch(qs, kt, vt, kv_len, layer_idx, packed_int4, return_state=False):
    """The kernel on (b, h, g, d) f32 queries; a group wider than one
    block serves runs as several launches, each reading K/V once. Returns
    the f32 output, or (output, m, l) with ``return_state``."""
    dev = qs.device
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
    pad = (-kt.shape[-1]) % 4
    if pad:  # the kernel reads 4 positions at a time; masking covers the pad
        kt, vt = F.pad(kt, (0, pad)), F.pad(vt, (0, pad))
    t_pad = kt.shape[-1]
    per_launch = min(MAX_GROUP, MAX_SCORES // t_pad)
    if per_launch < 1:
        raise ValueError(f"T_pad {t_pad} exceeds the kernel's {MAX_SCORES}")
    kv = _build.device_scalar(kv_len, dev)
    li = None if layer_idx is None else _build.device_scalar(layer_idx, dev)
    b, h, group, d = qs.shape
    outs, ms, ls = [], [], []
    for g0 in range(0, group, per_launch):
        q_part = qs[:, :, g0:g0 + per_launch].contiguous()
        g = q_part.shape[2]
        f32 = dict(dtype=torch.float32, device=dev)
        out = torch.empty((b, h, g, d), **f32)
        m, l = (torch.empty((b, h, g), **f32) for _ in range(2)) if return_state else (None, None)
        err = _build.load("decode_cross_attention")(
            q_part.data_ptr(), kt.data_ptr(), vt.data_ptr(),
            None if li is None else li.data_ptr(), kv.data_ptr(),
            out.data_ptr(), None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(), b, h, d, t_pad, g, mode,
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

"""Flash attention: the encoder self-attention, for serving and training.

Two layouts, each the JAX package's contract:

- ``flash_attention_tmaj``: the transposed (b*h, head_dim, T) layout,
  unmasked softmax(Q^T K / sqrt(d)), kernel ``csrc/flash_attention_tmaj.cu``.
  Differentiable: its backward goes through the row-major kernels below on
  (bh, T, 1, d) views, after a recompute of the row-major forward, as the
  JAX package's ``_flash_tmaj_bwd`` does. ``flash_attention_tmaj_rows``
  (serving) is the same kernel on (b, heads, 64, T) strided views, such as
  the channel-major output of the encoder's projection GEMMs, with the query
  and value biases added inside and a row-major (b, T, heads * 64) output,
  as the out-projection reads it; its backward is the same recompute.
- ``flash_attention`` (training): row-major (batch, T, heads, head_dim) with
  an optional additive mask, a ``torch.autograd.Function``. Its forward
  (``flash_attention_fwd``, kernel ``csrc/flash_attention.cu``) also returns
  the f32 log-sum-exp; its backward computes ``delta = rowsum(dO * O)`` in
  plain PyTorch and launches ``flash_attention_bwd_dq`` and
  ``flash_attention_bwd_dkv`` (``csrc/flash_attention_bwd.cu``). The mask
  gets a zero gradient.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (``*_plain``) for CPU tensors; it counts its launches
in ``<wrapper>.launches``. ``flash_attention_plain`` is the whole function
in plain PyTorch (f32 softmax, autograd through plain ops): the reference
the tests hold the route against. Softmax math is f32; outputs and
gradients come back in the input dtype, the log-sum-exp in f32.
``flash_attention_tmaj.launches`` counts every launch of the transposed
kernel, ``flash_attention_tmaj.rows_launches`` those through
``flash_attention_tmaj_rows``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---- transposed layout (serving) ----


def flash_attention_tmaj_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (bh, d, T) in, (bh, d, T) out."""
    d = q.shape[1]
    s = torch.einsum("bdq,bdk->bqk", q.float(), k.float()) * d**-0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bdk->bdq", p, v.float()).to(q.dtype)


def flash_attention_tmaj_rows_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_bias: Optional[torch.Tensor] = None,
    v_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the strided form: (b, h, d, T) views in,
    (b, T, h*d) out; the query bias rounded with q, the value bias added to
    the f32 output, as the kernel adds them."""
    b, h, d, t = q.shape
    if q_bias is not None:
        q = (q.float() + q_bias.float().view(h, d, 1)).to(q.dtype)
    s = torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float()) * d**-0.5
    o = torch.einsum("bhqk,bhdk->bqhd", torch.softmax(s, dim=-1), v.float())
    if v_bias is not None:
        o = o + v_bias.float().view(h, d)
    return o.reshape(b, t, h * d).to(q.dtype)


def _tmaj_launch(q, k, v, q_bias, v_bias) -> torch.Tensor:
    """The kernel on (b, h, 64, T) views of one stride pattern (time
    contiguous, channels ld apart, heads 64 ld apart): (b, T, h * 64)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (b, h, d, T) shape: {q.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be f32 or bf16: {q.dtype}")
    b, h, d, t_len = q.shape
    if d != 64:
        raise ValueError(f"the kernel takes head_dim 64, got {d}")
    sb, sh, ld, st = q.stride()
    biases = [x for x in (q_bias, v_bias) if x is not None]
    for x in (k, v, *biases):
        if x.device != q.device:
            raise ValueError("operands must be on one device")
    if any(x.stride() != q.stride() or x.data_ptr() % 16 for x in (q, k, v)) or (
        st != 1 or sh != d * ld or ld < t_len or max(sb, ld) >= 2**31
    ):
        raise ValueError(
            "q, k, v must share 16-byte aligned (b, h, 64, T) strides with time "
            f"contiguous and heads 64 channel rows apart: {q.stride()}"
        )
    for x in biases:
        if x.shape != (h * d,) or x.dtype != q.dtype or not x.is_contiguous() or x.data_ptr() % 4:
            raise ValueError(f"biases must be contiguous (h * 64,) in q's dtype: {x.shape}")
    out = torch.empty((b, t_len, h * d), dtype=q.dtype, device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = _build.load("flash_attention_tmaj")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(q_bias), ptr(v_bias), out.data_ptr(),
        b, h, d, t_len, sb, ld, _DTYPES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_tmaj")
    flash_attention_tmaj.launches += 1
    return out


def _tmaj_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_tmaj_plain(q, k, v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (bh, d, T) shape: {q.shape}")
    if any(not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    bh, d, t_len = q.shape
    one = lambda z: z.view(bh, 1, d, t_len)
    return _tmaj_launch(one(q), one(k), one(v), None, None).transpose(1, 2)


def _tmaj_rm_backward(q, k, v, g):
    """dq, dk, dv of softmax(q^T k / sqrt(d)) v through the row-major
    kernels, from (b, h, d, T) operands and the (b, T, h, d) cotangent."""
    rm = lambda z: z.permute(0, 3, 1, 2).contiguous()  # (b, T, h, d)
    qr, kr, vr = rm(q), rm(k), rm(v)
    out, lse = flash_attention_fwd(qr, kr, vr)
    grads = _flash_backward(qr, kr, vr, None, out, lse, g)
    return tuple(x.permute(0, 2, 3, 1) for x in grads)


class _FlashTmaj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _tmaj_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        one = lambda z: z[:, None]  # (bh, 1, d, T)
        grads = _tmaj_rm_backward(one(q), one(k), one(v), g.transpose(1, 2)[:, :, None, :])
        return tuple(x[:, 0] for x in grads)


def flash_attention_tmaj(
    q: torch.Tensor,  # (batch*heads, head_dim, T), time contiguous
    k: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """softmax(Q^T K / sqrt(d)) in the transposed layout; (bh, d, T) out."""
    return _FlashTmaj.apply(q, k, v)


class _FlashTmajRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_bias, v_bias):
        ctx.save_for_backward(q, k, v, q_bias)
        if q.device.type == "cpu":
            return flash_attention_tmaj_rows_plain(q, k, v, q_bias, v_bias)
        flash_attention_tmaj.rows_launches += 1
        return _tmaj_launch(q, k, v, q_bias, v_bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_bias = ctx.saved_tensors
        b, h, d, t = q.shape
        if q_bias is not None:
            q = (q.float() + q_bias.float().view(h, d, 1)).to(q.dtype)
        dq, dk, dv = _tmaj_rm_backward(q, k, v, g.reshape(b, t, h, d))
        need = ctx.needs_input_grad
        dqb = dq.float().sum((0, 3)).reshape(-1).to(q.dtype) if need[3] else None
        dvb = g.float().sum((0, 1)).to(q.dtype) if need[4] else None
        return dq, dk, dv, dqb, dvb


def flash_attention_tmaj_rows(
    q: torch.Tensor,  # (batch, heads, 64, T): time contiguous, heads 64 channel rows apart
    k: torch.Tensor,
    v: torch.Tensor,
    q_bias: Optional[torch.Tensor] = None,  # (heads * 64,)
    v_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax((Q + b_q)^T K / sqrt(d)) (V + b_v) from strided time-major
    views, such as ``w @ x.t()`` viewed per head; (batch, T, heads * 64)
    out, row-major."""
    return _FlashTmajRows.apply(q, k, v, q_bias, v_bias)


flash_attention_tmaj.launches = 0
flash_attention_tmaj.rows_launches = 0


# ---- row-major layout (training) ----


def _mask4(mask: Optional[torch.Tensor], b, h, q_len, kv_len):
    """The additive mask as an f32 (b, h, q, kv) view (broadcast axes have
    stride 0), or None."""
    if mask is None:
        return None
    return mask.float().broadcast_to(b, h, q_len, kv_len)


def _scores(q, k, mask4):
    """f32 (b, h, q, kv) scaled scores plus the mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    return s if mask4 is None else s + mask4


def flash_attention_fwd_plain(q, k, v, mask=None):
    """Plain version of the forward kernel: (out in q.dtype, f32 lse
    (b, h, q_len))."""
    b, q_len, h, _ = q.shape
    s = _scores(q, k, _mask4(mask, b, h, q_len, k.shape[1]))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def _recompute_p_ds(q, k, v, do, lse, delta, mask):
    b, q_len, h, _ = q.shape
    s = _scores(q, k, _mask4(mask, b, h, q_len, k.shape[1]))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * q.shape[-1] ** -0.5
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, mask=None):
    """Plain version of the dQ kernel: dS K in q.dtype."""
    _, ds = _recompute_p_ds(q, k, v, do, lse, delta, mask)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, mask=None):
    """Plain version of the dK/dV kernel: (dS^T Q, P^T dO) in k's and v's
    dtypes."""
    p, ds = _recompute_p_ds(q, k, v, do, lse, delta, mask)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype)
    return dk, dv


def _check_rowmajor(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"operands must all be f32 or bf16: {[t.dtype for t in ts]}")
    for t in ts:
        if t.device != q.device:
            raise ValueError("operands must be on one device")
        if t.dim() != 4 or t.shape[-1] != 64 or t.shape[0] != q.shape[0] or (
            t.shape[2] != q.shape[2]
        ):
            raise ValueError(f"expected (batch, T, heads, 64) operands: {t.shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")


def _rows(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Row-major operands as the kernels take them: contiguous (a no-op for
    the model's projections)."""
    return tuple(t.contiguous() for t in ts)


def _mask_args(mask4: Optional[torch.Tensor]):
    if mask4 is None:
        return None, (0, 0, 0, 0)
    return mask4, tuple(mask4.stride())


def _stats(lse: torch.Tensor, delta: Optional[torch.Tensor] = None):
    for t in (lse,) if delta is None else (lse, delta):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous f32 (b, h, q_len)")


def flash_attention_fwd(q, k, v, mask=None):
    """Forward kernel: (out (b, q_len, h, 64) in q.dtype, f32 lse (b, h,
    q_len))."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, mask)
    q, k, v = _rows(q, k, v)
    _check_rowmajor(q, k, v)
    b, q_len, h, d = q.shape
    kv_len = k.shape[1]
    m4, ms = _mask_args(_mask4(mask, b, h, q_len, kv_len))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=q.device)
    err = _build.load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if m4 is None else m4.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, q_len, kv_len, d, *ms, _DTYPES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, mask=None):
    """dQ kernel: (b, q_len, h, 64) in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, mask)
    q, k, v, do = _rows(q, k, v, do)
    _check_rowmajor(q, k, v, do)
    _stats(lse, delta)
    b, q_len, h, d = q.shape
    kv_len = k.shape[1]
    m4, ms = _mask_args(_mask4(mask, b, h, q_len, kv_len))
    dq = torch.empty_like(q)
    err = _build.load("flash_attention_bwd", "flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if m4 is None else m4.data_ptr(), dq.data_ptr(),
        b, h, q_len, kv_len, d, *ms, _DTYPES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, mask=None):
    """dK/dV kernel: two (b, kv_len, h, 64) tensors in k's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, mask)
    q, k, v, do = _rows(q, k, v, do)
    _check_rowmajor(q, k, v, do)
    _stats(lse, delta)
    b, q_len, h, d = q.shape
    kv_len = k.shape[1]
    m4, ms = _mask_args(_mask4(mask, b, h, q_len, kv_len))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load("flash_attention_bwd", "flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if m4 is None else m4.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, q_len, kv_len, d, *ms, _DTYPES[q.dtype],
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


for _w in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _w.launches = 0


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (b, h, q_len) contiguous."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_backward(q, k, v, mask, out, lse, g):
    do = g.to(q.dtype)
    delta = flash_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, mask)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = flash_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, mask, out, lse, g)
        dmask = torch.zeros_like(mask) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dmask


def flash_attention(
    q: torch.Tensor,  # (batch, q_len, heads, head_dim)
    k: torch.Tensor,  # (batch, kv_len, heads, head_dim)
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # additive, bcast (b, heads, q, kv)
) -> torch.Tensor:
    """Differentiable flash attention: (batch, q_len, heads, head_dim) in
    q.dtype; the forward kernel, then the flash backward kernels."""
    return _Flash.apply(q, k, v, mask)


def flash_attention_plain(q, k, v, mask=None):
    """The same function in plain PyTorch (f32 softmax; autograd through
    plain ops)."""
    b, q_len, h, _ = q.shape
    p = torch.softmax(_scores(q, k, _mask4(mask, b, h, q_len, k.shape[1])), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)

"""Encoder self-attention in the transposed (b*h, head_dim, T) layout.

``flash_attention_tmaj`` launches the hand-written CUDA kernel
(``csrc/flash_attention_tmaj.cu``) for a CUDA tensor and runs the plain
version for a CPU tensor. Same contract as the JAX package's
``flash_attention_tmaj``: unmasked softmax(QK^T / sqrt(d)) V, f32 softmax,
output in the input dtype.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_tmaj_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (bh, d, T) in, (bh, d, T) out."""
    d = q.shape[1]
    s = torch.einsum("bdq,bdk->bqk", q.float(), k.float()) * d**-0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bdk->bdq", p, v.float()).to(q.dtype)


def flash_attention_tmaj(
    q: torch.Tensor,  # (batch*heads, head_dim, T), time contiguous
    k: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """softmax(Q^T K / sqrt(d)) in the transposed layout; (bh, d, T) out."""
    if q.device.type == "cpu":
        return flash_attention_tmaj_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (bh, d, T) shape: {q.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be f32 or bf16: {q.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    bh, d, t_len = q.shape
    if d != 64:
        raise ValueError(f"the kernel takes head_dim 64, got {d}")
    out = torch.empty_like(q)
    err = _build.load("flash_attention_tmaj")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, d, t_len, _DTYPES[q.dtype], _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_tmaj")
    flash_attention_tmaj.launches += 1
    return out


flash_attention_tmaj.launches = 0

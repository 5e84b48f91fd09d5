"""Plain multi-head attention: the port's attention reference.

Mirrors the JAX package's ``ops/attention.py``: einsum QK^T in f32, additive
mask, f32 softmax, einsum over V. The kernels' plain versions and the
Qformer and decoder prefill attention use it.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(
    q: torch.Tensor,  # (batch, q_len, heads, head_dim)
    k: torch.Tensor,  # (batch, kv_len, heads, head_dim)
    v: torch.Tensor,  # (batch, kv_len, heads, head_dim)
    mask: Optional[torch.Tensor] = None,  # additive, bcast (b, h, q, kv)
    out_dtype: Optional[torch.dtype] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    heads_group=None,
) -> torch.Tensor:
    """Scaled dot-product attention; returns (batch, q_len, heads, head_dim)
    in ``out_dtype`` (default q.dtype). Scores and softmax run in f32.
    ``dropout_rate`` > 0: inverted dropout on the softmax weights (the
    Qformer's training attention-probs dropout), drawn from ``generator``;
    ``heads_group``: the model group whose ranks hold the other heads (the
    mask is drawn for every head and this rank keeps its own)."""
    out_dtype = out_dtype or q.dtype
    scale = q.shape[-1] ** -0.5
    # f32 products of the (possibly bf16) operands: the JAX version's
    # preferred_element_type=f32 contraction
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask.float()
    weights = dropout(torch.softmax(scores, dim=-1), dropout_rate, generator,
                      heads=None if heads_group is None else (1, heads_group))
    out = torch.einsum(
        "bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float()
    )
    return out.to(out_dtype)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
    heads=None,
) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, drawn from ``generator`` (torch's default
    generator when None); the identity at rate 0. The draw covers the whole
    batch of a data-parallel step (``parallel.mesh.global_rand``), and
    with ``heads=(dim, group)`` every head of a tensor-parallel split."""
    if rate == 0.0:
        return x
    from ..parallel.mesh import global_rand

    keep = global_rand(x.shape, generator, x.device, heads) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def causal_mask(
    q_len: int, kv_len: Optional[int] = None, device=None
) -> torch.Tensor:
    """Additive causal mask (q_len, kv_len): 0 on/below the diagonal, -inf
    above, aligned so query i attends keys [0, kv_len - q_len + i]."""
    kv_len = kv_len or q_len
    q_ids = torch.arange(q_len, device=device)[:, None]
    k_ids = torch.arange(kv_len, device=device)[None, :]
    allowed = k_ids <= q_ids + (kv_len - q_len)
    zero = torch.zeros((), device=device)
    return torch.where(allowed, zero, torch.tensor(float("-inf"), device=device))


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Additive key-padding mask (batch, 1, 1, max_len): 0 valid, -1e9 pad."""
    valid = torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
    return torch.where(valid, 0.0, -1e9).float()[:, None, None, :]

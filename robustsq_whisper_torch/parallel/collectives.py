"""The collectives of tensor, sequence and data parallelism, as autograd
functions.

Megatron-LM's pairs, each a forward collective and its backward:

- ``copy_to``: identity forward, all-reduce of the gradient (the input of
  a column-parallel Linear, whose ranks each produce part of the input's
  gradient);
- ``reduce_from``: all-reduce forward, identity backward (the output of a
  row-parallel Linear: each rank holds a partial sum);
- ``gather_from``: all-gather along ``dim`` forward, this rank's chunk of
  the gradient backward (vocabulary-split logits, and the residual stream
  leaving a sequence-parallel region: the gradient that comes back is the
  same on every rank);
- ``scatter_to``: this rank's chunk forward, all-gather of the gradient
  backward (the residual stream entering a sequence-parallel region);
- ``reduce_scatter``: reduce-scatter along ``dim`` forward, all-gather
  backward (a row-parallel output inside a sequence-parallel block);
- ``gather_sum``: all-gather along ``dim`` forward, reduce-scatter of the
  gradient backward (a tensor whose gathered copy feeds a loss that every
  rank computes on its own rows: the pooled enrollments of Arc-InfoNCE, and
  the fully sharded parameters gathered for use).

Each takes the process group; with ``group=None`` or a group of one rank
every function is the identity. The chunks are equal: the caller checks
that ``dim`` divides.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n, dim=0), dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts: List[torch.Tensor] = list(x.chunk(n, dim=dim))
    stacked = torch.cat([p.contiguous() for p in parts], dim=0) if dim else x.contiguous()
    out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(out, stacked, group=group)
    return out


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherFrom.apply(x, dim % x.dim(), group)


def scatter_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ScatterTo.apply(x, dim % x.dim(), group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceScatter.apply(x, dim % x.dim(), group)


def gather_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherSum.apply(x, dim % x.dim(), group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank, concatenated in rank order (no gradient)."""
    return x if group_size(group) == 1 else _all_gather(x, 0, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of ``x`` over ``group`` (no gradient)."""
    return x if group_size(group) == 1 else _all_reduce(x, group)

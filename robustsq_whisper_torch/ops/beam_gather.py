"""Beam reorder of the flat decode cache.

``beam_reorder_cache`` launches the hand-written CUDA kernel
(``csrc/beam_reorder_cache.cu``) for CUDA tensors and runs the plain
version for CPU tensors. The contract is the JAX package's
``beam_reorder_cache`` on 4-D leaves (its ``_permute4d_kernel`` route):

- every leaf is (layers, rows, T_pad, n_state) with T_pad a multiple of 8;
- ``out[:, i, :P] = x[:, src_rows[i], :P]`` with
  ``P = 8 * clip(ceil(live / 8), 1, T_pad / 8)`` (``live=None`` is all of
  T_pad): whole 8-position chunks, at least one;
- positions ``>= P`` are left as they were. The eager beam loop relies on
  that tail being zeros; the deferred one on it holding the logically
  ordered window.

The port reorders in place (the JAX output aliases its input) and returns
the same leaves. The flattened zero-tail route of other leaf shapes
(``_permute_kernel``) is ROADMAP B4.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build

CHUNK = 8  # positions a reorder chunk holds


def live_positions(live: Optional[int], t_pad: int) -> int:
    """P: the live positions rounded up to whole chunks, at least one."""
    n_chunks = t_pad // CHUNK
    if live is None:
        return t_pad
    return CHUNK * min(max(-(-int(live) // CHUNK), 1), n_chunks)


def beam_reorder_cache_plain(
    leaves: Sequence[torch.Tensor], src_rows: torch.Tensor, positions: int
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: reorders rows of positions
    [0, positions) of every leaf in place."""
    src = src_rows.long()
    for x in leaves:
        x[:, :, :positions] = x[:, :, :positions].index_select(1, src)
    return tuple(leaves)


def beam_reorder_cache(
    cache: Sequence[torch.Tensor],  # leaves (layers, rows, T_pad, n_state)
    src_rows: torch.Tensor,  # (rows,) source row of each output row
    live: Optional[int] = None,  # positions [0, live) hold data
    time_len: Optional[int] = None,  # T_pad, given with live as in JAX
) -> Tuple[torch.Tensor, ...]:
    """Reorder every leaf's row axis (axis 1) by ``src_rows`` over the live
    chunks, in place; returns the leaves."""
    cache = tuple(cache)
    layers, rows, t_pad = cache[0].shape[:3]
    for x in cache:
        if x.dim() != 4 or x.shape[:3] != (layers, rows, t_pad):
            raise ValueError(f"leaves must share (layers, rows, T): {x.shape}")
        if t_pad % CHUNK or x.shape[3] % 128:
            raise NotImplementedError(
                "leaves whose (T, n_state) do not tile (8, 128) take the "
                "flattened zero-tail reorder, ROADMAP B4"
            )
    if src_rows.shape != (rows,):
        raise ValueError(f"src_rows {tuple(src_rows.shape)} for {rows} rows")
    if (live is None) != (time_len is None) or time_len not in (None, t_pad):
        raise ValueError("live comes with time_len, the leaves' T")
    positions = live_positions(live, t_pad)
    dev = src_rows.device
    if dev.type == "cpu":
        return beam_reorder_cache_plain(cache, src_rows, positions)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    src = src_rows.to(torch.int32).contiguous()
    for x in cache:
        if x.device != dev:
            raise ValueError("src_rows and the leaves must be on one device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("leaves must be contiguous and 16-byte aligned")
    # the kernel moves bytes: one launch takes two leaves of equal row size
    row_bytes = [x.shape[3] * x.element_size() for x in cache]
    i = 0
    while i < len(cache):
        n = 2 if row_bytes[i:i + 2] == [row_bytes[i]] * 2 else 1
        pair = cache[i:i + n]
        err = _build.load("beam_reorder_cache")(
            src.data_ptr(), pair[0].data_ptr(),
            pair[1].data_ptr() if n == 2 else None,
            n, layers, rows, t_pad, row_bytes[i], positions,
            _build.stream_ptr(dev),
        )
        _build.check(err, "beam_reorder_cache")
        beam_reorder_cache.launches += 1
        i += n
    return cache


beam_reorder_cache.launches = 0

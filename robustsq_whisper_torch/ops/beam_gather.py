"""Beam reorder of the decode cache.

``beam_reorder_cache`` launches the hand-written CUDA kernels
(``csrc/beam_reorder_cache.cu``) for CUDA tensors and runs the plain
versions for CPU tensors. The contract is the JAX package's
``beam_reorder_cache``, which routes each leaf by its shape:

- 4-D leaves (layers, rows, T_pad, n) with T_pad a multiple of 8 and n of
  128 (the flat cache, dense or int8, and its bf16 scale leaf; the
  ``_permute4d_kernel`` route): ``out[:, i, :P] = x[:, src_rows[i], :P]``
  with ``P = 8 * clip(ceil(live / 8), 1, T_pad / 8)`` (``live=None`` is all
  of T_pad), whole 8-position chunks, at least one. Positions ``>= P`` are
  left as they were: the eager beam loop relies on that tail being zeros,
  the deferred one on it holding the logically ordered window. The port
  reorders these in place (the JAX output aliases its input) and returns
  the same leaves.
- every other leaf (the 5-D cache (layers, rows, T, heads, hd) and the
  int8 form's f32 (layers, rows, T, heads) scales; the ``_permute_kernel``
  route): the row payload is seen as S rows of 128 elements, S a multiple
  of 32. Out of place, as the JAX call is not aliased: ``out[:, i, :E] =
  x[:, src_rows[i], :E]`` and ``out[:, i, E:] = 0``, the tail written
  without being read, with ``E = 32 * clip(ceil(ceil(live * S / T) / 32),
  1, S / 32)`` rows (``live_rows``). The decode cache's tail is zeros, so
  this equals a full gather there.

The wrapper counts launches of the in-place kernel in ``launches`` and of
the flattened one in ``flat_launches``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build

CHUNK = 8  # positions a chunk of the 4-D route holds
FLAT_CHUNK = 32  # rows of 128 elements a chunk of the flattened route holds


def live_positions(live: Optional[int], t_pad: int) -> int:
    """P: the live positions rounded up to whole chunks, at least one."""
    n_chunks = t_pad // CHUNK
    if live is None:
        return t_pad
    return CHUNK * min(max(-(-int(live) // CHUNK), 1), n_chunks)


def live_rows(live: Optional[int], s_full: int, time_len: Optional[int]) -> int:
    """E: the rows of 128 elements of the flattened payload that hold the
    first ``live`` of ``time_len`` positions, rounded up to whole chunks of
    32 rows, at least one."""
    if live is None:
        return s_full
    valid_s = -(-int(live) * s_full // time_len)
    chunks = max(1, -(-valid_s // FLAT_CHUNK))
    return FLAT_CHUNK * min(chunks, s_full // FLAT_CHUNK)


def beam_reorder_cache_plain(
    leaves: Sequence[torch.Tensor], src_rows: torch.Tensor, positions: int
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the in-place kernel: reorders rows of
    positions [0, positions) of every 4-D leaf in place."""
    src = src_rows.long()
    for x in leaves:
        x[:, :, :positions] = x[:, :, :positions].index_select(1, src)
    return tuple(leaves)


def beam_reorder_flat_plain(
    x: torch.Tensor, src_rows: torch.Tensor, rows_live: int
) -> torch.Tensor:
    """Plain PyTorch version of the flattened kernel: a new leaf whose row
    i holds the first ``rows_live`` rows of 128 elements of row
    ``src_rows[i]`` and zeros after."""
    layers, rows = x.shape[:2]
    flat = x.reshape(layers, rows, -1)
    out = torch.zeros_like(flat)
    n = rows_live * 128
    out[:, :, :n] = flat[:, :, :n].index_select(1, src_rows.long())
    return out.reshape(x.shape)


def _is_packed(x: torch.Tensor) -> bool:
    return x.dim() == 4 and x.shape[3] % 128 == 0 and x.shape[2] % CHUNK == 0


def beam_reorder_cache(
    cache: Sequence[torch.Tensor],  # leaves (layers, rows, T, ...)
    src_rows: torch.Tensor,  # (rows,) source row of each output row
    live: Optional[int] = None,  # positions [0, live) hold data
    time_len: Optional[int] = None,  # T, given with live as in JAX
) -> Tuple[torch.Tensor, ...]:
    """Reorder every leaf's row axis (axis 1) by ``src_rows`` over the live
    prefix: 4-D flat leaves in place, the others into new leaves with a
    zero tail. Returns the leaves in the input order."""
    cache = tuple(cache)
    layers, rows = cache[0].shape[:2]
    for x in cache:
        if x.dim() < 3 or x.shape[:2] != (layers, rows):
            raise ValueError(f"leaves must share (layers, rows): {x.shape}")
        if time_len is not None and x.shape[2] != time_len:
            raise ValueError(f"time_len {time_len} is not the leaves' T {x.shape[2]}")
    if src_rows.shape != (rows,):
        raise ValueError(f"src_rows {tuple(src_rows.shape)} for {rows} rows")
    if (live is None) != (time_len is None):
        raise ValueError("live comes with time_len, the leaves' T")
    out = list(cache)
    packed = [i for i, x in enumerate(cache) if _is_packed(x)]
    rest = [i for i, x in enumerate(cache) if not _is_packed(x)]
    if len({cache[i].shape[2] for i in packed}) > 1:
        raise ValueError("the 4-D leaves must share T")
    flat_rows = {}
    for i in rest:
        x = cache[i]
        s_full, odd = divmod(x.numel(), layers * rows * 128)
        if odd or s_full % FLAT_CHUNK:
            raise ValueError(
                f"leaf {tuple(x.shape)}: its row payload must be whole chunks "
                f"of {FLAT_CHUNK} x 128 elements (the beam decoder pads the "
                "cache length so it is)"
            )
        flat_rows[i] = live_rows(live, s_full, time_len)
    dev = src_rows.device
    if dev.type == "cpu":
        if packed:
            t_pad = cache[packed[0]].shape[2]
            beam_reorder_cache_plain(
                [cache[i] for i in packed], src_rows, live_positions(live, t_pad)
            )
        for i in rest:
            out[i] = beam_reorder_flat_plain(cache[i], src_rows, flat_rows[i])
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    src = src_rows.to(torch.int32).contiguous()
    for x in cache:
        if x.device != dev:
            raise ValueError("src_rows and the leaves must be on one device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("leaves must be contiguous and 16-byte aligned")
    _launch_packed([cache[i] for i in packed], src, live, layers, rows)
    for i in rest:
        out[i] = torch.empty_like(cache[i])
    row_bytes = {i: cache[i].numel() // (layers * rows) * cache[i].element_size() for i in rest}
    # one launch takes two leaves of equal row bytes and live rows
    while rest:
        i = rest.pop(0)
        j = next((j for j in rest if row_bytes[j] == row_bytes[i]
                  and flat_rows[j] == flat_rows[i]), None)
        if j is not None:
            rest.remove(j)
        pair = [i] if j is None else [i, j]
        err = _build.load("beam_reorder_cache", "beam_reorder_cache_flat")(
            src.data_ptr(), cache[i].data_ptr(),
            None if j is None else cache[j].data_ptr(), out[i].data_ptr(),
            None if j is None else out[j].data_ptr(), len(pair), layers, rows,
            row_bytes[i], flat_rows[i] * 128 * cache[i].element_size(),
            _build.stream_ptr(dev),
        )
        _build.check(err, "beam_reorder_cache_flat")
        beam_reorder_cache.flat_launches += 1
    return tuple(out)


def _launch_packed(leaves, src, live, layers, rows) -> None:
    """The in-place kernel over the 4-D leaves; one launch takes two leaves
    of equal row size (the kernel moves bytes)."""
    if not leaves:
        return
    t_pad = leaves[0].shape[2]
    positions = live_positions(live, t_pad)
    row_bytes = [x.shape[3] * x.element_size() for x in leaves]
    i = 0
    while i < len(leaves):
        n = 2 if row_bytes[i:i + 2] == [row_bytes[i]] * 2 else 1
        pair = leaves[i:i + n]
        err = _build.load("beam_reorder_cache")(
            src.data_ptr(), pair[0].data_ptr(),
            pair[1].data_ptr() if n == 2 else None,
            n, layers, rows, t_pad, row_bytes[i], positions,
            _build.stream_ptr(src.device),
        )
        _build.check(err, "beam_reorder_cache")
        beam_reorder_cache.launches += 1
        i += n


beam_reorder_cache.launches = 0
beam_reorder_cache.flat_launches = 0

"""The self-cache read's schedule against the JAX functions, on the CPU.

On the card, ``decode_self_attention`` (dense and int8 cache) and
``settled_self_attention`` are one read (``csrc/self_cache_read.cuh``):
one CTA a (row, head) takes [0, len) in tiles of ``SELF_TILE`` positions,
and each of its 4 warps takes ``SELF_TILE / 4`` consecutive positions of a
tile. A warp takes the max of its positions' log2-scaled scores first,
then the exponentials, l and P.V in one pass, and carries an
online-softmax state across tiles; the warps' states merge in warp order,
and the new token merges last. ``read_schedule`` below is that schedule in
plain PyTorch. It is held against the JAX ``decode_self_attention``
(dense, int8) and ``settled_self_attention`` (a row map with repeats),
their Pallas kernels in interpret mode, and against the port's plain
versions, at the length edges of a tile (0, 1, TILE - 1, TILE, TILE + 1),
the main path's 52, and the last position and the full cache of Whisper's
448-position text context, so an empty warp, a partial tile and the empty
read are covered. Both sides compute in f32; the tolerance is f32
summation-order noise (1e-5).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robustsq_whisper_tpu.ops import self_attention as jself
from robustsq_whisper_torch.ops import self_attention as tself

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 vs f32, different summation order
T_PAD = 448  # Whisper's n_text_ctx
TILE = tself.SELF_TILE
WARPS = 4  # warps a CTA: each takes TILE / WARPS consecutive positions a tile
HEADS, N_STATE, ROWS, LAYERS = 2, 128, 3, 2
EDGES = {"0": 0, "1": 1, "tile-1": TILE - 1, "tile": TILE, "tile+1": TILE + 1,
         "52": 52, "447": 447, "448": 448}


@functools.lru_cache(maxsize=None)
def _inputs(mode: str):
    """q, k_new, v_new (rows, n_state) f32; the cache (layers, rows, T_PAD,
    n_state): f32 K/V, or int8 codes with a bf16 (layers, rows, T_PAD,
    128) scale leaf (K's scales in lanes [0, heads), V's in [heads, 2
    heads)); a row map with repeats."""
    rng = np.random.default_rng(len(mode))
    q, kn, vn = (rng.standard_normal((ROWS, N_STATE), np.float32) for _ in range(3))
    shape = (LAYERS, ROWS, T_PAD, N_STATE)
    if mode == "int8":
        k8, v8 = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        sc = np.zeros((*shape[:3], 128), np.float32)
        sc[..., : 2 * HEADS] = rng.uniform(0.005, 0.02, (*shape[:3], 2 * HEADS))
        sc = torch.from_numpy(sc).bfloat16()
        cache = (torch.from_numpy(k8), torch.from_numpy(v8), sc)
    else:
        cache = tuple(torch.from_numpy(rng.standard_normal(shape, np.float32)) for _ in range(2))
    row_map = np.array([2, 0, 2], np.int32)  # row 2 is read twice, row 1 never
    return q, kn, vn, cache, row_map


def _jax(x: torch.Tensor):
    if x.dtype == torch.bfloat16:  # the same values through f32
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


@functools.lru_cache(maxsize=None)
def _jax_ref(mode: str, length: int):
    q, kn, vn, cache, row_map = _inputs(mode)
    jcache = tuple(_jax(c) for c in cache)
    if mode == "settled":
        res = jself.settled_self_attention(
            jnp.asarray(q), jcache, jnp.int32(length), jnp.int32(1), jnp.asarray(row_map),
            heads=HEADS, interpret=True,
        )
        return tuple(np.asarray(x) for x in res)
    return np.asarray(jself.decode_self_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jcache, jnp.int32(length),
        jnp.int32(1), heads=HEADS, interpret=True,
    ))


def _merge(states):
    """Online-softmax states (m, l, acc) in log2 units merged in order; an
    empty state (m = -inf) weighs 0."""
    mt = torch.stack([m for m, _, _ in states]).amax(dim=0)
    num, den = 0.0, 0.0
    for m, l, acc in states:
        w = torch.where(m == -math.inf, 0.0, torch.exp2(m - mt))
        num = num + w[..., None] * acc
        den = den + w * l
    return mt, den, num


def read_schedule(q, k, v, length, scales=None, new=None):
    """The kernel's schedule in plain PyTorch. q: (R, H, D) f32 unscaled;
    k, v: (R, T, H, D) f32, each row's physical slab (int8 codes as
    floats); scales: (ks, vs), each (R, T, H), for the int8 cache; new:
    (k_new, v_new), each (R, H, D), for the decode read. Returns the
    normalised output with the new token merged last, or without ``new``
    the state (m in natural units, l, acc) with (-1e30, 0, 0) when empty."""
    qs = q * (0.125 * math.log2(math.e))  # scores in log2 units
    span = TILE // WARPS
    empty = (torch.full(q.shape[:2], -math.inf), torch.zeros(q.shape[:2]), torch.zeros(q.shape))
    warps = []
    for w in range(WARPS):
        m, l, acc = empty
        for tile in range(-(-length // TILE)):
            a = tile * TILE + w * span
            b = min(a + span, length)
            if a >= length:  # the warp holds no live position
                continue
            s = torch.einsum("rhd,rthd->rth", qs, k[:, a:b])
            if scales is not None:
                s = s * scales[0][:, a:b]
            mn = torch.maximum(m, s.amax(dim=1))  # the tile's max first
            alpha = torch.exp2(m - mn)
            p = torch.exp2(s - mn[:, None])
            pv = p * scales[1][:, a:b] if scales is not None else p
            l = l * alpha + p.sum(dim=1)
            acc = acc * alpha[..., None] + torch.einsum("rth,rthd->rhd", pv, v[:, a:b])
            m = mn
        warps.append((m, l, acc))
    mc, den, num = _merge(warps)
    if new is None:
        return torch.where(mc == -math.inf, tself.NEG, mc * math.log(2)), den, num
    s_new = (qs * new[0]).sum(dim=-1)
    mf = torch.maximum(mc, s_new)
    wc = torch.where(mc == -math.inf, 0.0, torch.exp2(mc - mf))
    pn = torch.where(s_new >= mc, 1.0, torch.exp2(s_new - mf))
    return (num * wc[..., None] + pn[..., None] * new[1]) / (den * wc + pn)[..., None]


def _heads(x):
    return x.float().reshape(*x.shape[:-1], HEADS, -1)


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("mode", ["dense", "int8", "settled"])
def test_read_schedule_matches_jax(mode, edge):
    """The decode output (dense and int8 cache) or the settled state
    against JAX's and against the port's plain version. The empty decode
    read returns exactly v_new; the empty settled state is (-1e30, 0, 0),
    whose m is JAX's."""
    length = EDGES[edge]
    q, kn, vn, cache, row_map = _inputs(mode)
    tq, tkn, tvn = map(torch.from_numpy, (q, kn, vn))
    rows = torch.from_numpy(row_map).long() if mode == "settled" else torch.arange(ROWS)
    k, v = (_heads(c[1].index_select(0, rows)) for c in cache[:2])
    scales = None
    if mode == "int8":
        sc = cache[2][1].float()
        scales = (sc[..., :HEADS], sc[..., HEADS:2 * HEADS])
    ref = _jax_ref(mode, length)
    if mode == "settled":
        plain = tself.settled_self_attention(
            tq, cache, length, 1, torch.from_numpy(row_map), heads=HEADS
        )
    else:
        plain = tself.decode_self_attention(tq, tkn, tvn, cache, length, 1, heads=HEADS)
    if mode == "settled":
        m, l, acc = read_schedule(_heads(tq), k, v, length)
        got = (m, l, acc.reshape(ROWS, N_STATE))
        for g_, p in zip(got, plain):
            torch.testing.assert_close(g_, p, **TOL)
        if length == 0:
            # the TPU kernel's l and acc differ there, its m is the same
            # -1e30, so the state weighs 0 in a merge either way
            assert (m == -1e30).all() and not l.any() and not acc.any()
            np.testing.assert_array_equal(m.numpy(), ref[0])
            return
        for g_, r in zip(got, ref):
            np.testing.assert_allclose(g_.numpy(), r, **TOL)
        return
    out = read_schedule(
        _heads(tq), k, v, length, scales, (_heads(tkn), _heads(tvn))
    ).reshape(ROWS, N_STATE)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    torch.testing.assert_close(out, plain, **TOL)
    if length == 0:
        assert torch.equal(out, tvn)

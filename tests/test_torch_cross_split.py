"""The cross kernel's split schedule against the JAX function, on the CPU.

The card's ``decode_cross_attention`` splits [0, kv_len) into tiles of
``TILE[mode]`` positions and hands S tile-aligned chunks to the S CTAs of
a cluster; each CTA leaves its online-softmax state (m, l, acc) and rank 0
merges them in rank order. ``split_schedule`` below is that schedule in
plain PyTorch. It is held against the JAX ``decode_cross_attention`` (its
Pallas kernel in interpret mode) and against the port's plain version for
S = 1..8, at the kv_len edges of a tile (0, 1, TILE - 1, TILE, TILE + 1)
and the main path's 1516, so a chunk wholly past kv_len and the all-empty
row are covered. ``choose_splits``, the host's choice of S, is tested as
the pure function it is. Both sides compute in f32; the tolerance is f32
summation-order noise (1e-5).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robustsq_whisper_tpu.ops import decode_attention as jdec
from robustsq_whisper_torch.ops import decode_attention as tdec

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 vs f32, different summation order
T_PAD = 1536  # the main path's padded cross length (a multiple of JAX's 512)
KV_EDGES = ["0", "1", "tile-1", "tile", "tile+1", "1516"]
H100_SMS = 132


def _kv(edge: str, mode: str) -> int:
    tile = tdec.TILE[_mode_id(mode)]
    return {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(edge) or int(edge)


def _mode_id(mode: str) -> int:
    return tdec.PACKED_INT4_MODE if mode == "int4" else 2


@functools.lru_cache(maxsize=None)
def _inputs(mode: str, group: int):
    """q (2, 2, group, 64) f32, k_scale (2, 2, 64), stacked K/V of two
    layers: packed int4 codes, or bf16 values."""
    rng = np.random.default_rng(group)
    q = rng.standard_normal((2, 2, group, 64), np.float32)
    k_s = rng.uniform(0.05, 0.2, (2, 2, 64)).astype(np.float32)
    if mode == "int4":
        kt, vt = (
            np.array(jdec.pack_int4(jnp.asarray(rng.integers(-8, 8, (2, 2, 2, 64, T_PAD)))))
            for _ in range(2)
        )
        return q, k_s, kt, vt
    kt, vt = (
        torch.from_numpy(rng.standard_normal((2, 2, 2, 64, T_PAD), np.float32)).bfloat16()
        for _ in range(2)
    )
    return q, k_s * 0.1, kt, vt  # bf16 values are larger than codes / 8


def _torch_kv(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


def _jax_kv(x):
    if isinstance(x, torch.Tensor):  # bf16: the same values through f32
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x)


@functools.lru_cache(maxsize=None)
def _jax_ref(mode: str, group: int, kv_len: int, return_state: bool):
    q, k_s, kt, vt = _inputs(mode, group)
    jq = jnp.asarray(q if group > 1 else q[:, :, 0])
    scales = () if return_state else (jnp.asarray(k_s),)
    res = jdec.decode_cross_attention(
        jq, _jax_kv(kt), _jax_kv(vt), *scales, kv_len=jnp.int32(kv_len),
        layer_idx=jnp.int32(1), interpret=True, packed_int4=mode == "int4",
        group=group, return_state=return_state,
    )
    return tuple(np.asarray(x) for x in res) if return_state else np.asarray(res)


def split_schedule(qs, kt, vt, kv_len, layer, packed, splits, tile, return_state):
    """The kernel's schedule in plain PyTorch: [0, kv_len) in tiles of
    ``tile`` positions, ``splits`` tile-aligned chunks of ceil(tiles /
    splits) tiles (the last ones may be empty), each chunk's (m, l, acc),
    merged in rank order. qs: (b, h, g, d) f32, already scaled."""
    kt, vt = kt[layer], vt[layer]
    if packed:
        kt, vt = tdec.unpack_int4(kt), tdec.unpack_int4(vt)
    kt, vt = kt.float(), vt.float()
    live = -(-kv_len // tile)
    per = -(-live // splits)
    states = []
    for rank in range(splits):
        a = min(rank * per, live) * tile
        b = min(min((rank + 1) * per, live) * tile, kv_len)
        s = torch.einsum("bhgd,bhdt->bhgt", qs, kt[..., a:b])
        m = s.amax(dim=-1) if b > a else torch.full(qs.shape[:3], float("-inf"))
        p = torch.exp(s - m[..., None]) if b > a else s
        states.append((m, p.sum(dim=-1), torch.einsum("bhgt,bhdt->bhgd", p, vt[..., a:b])))
    mt = torch.stack([m for m, _, _ in states]).amax(dim=0)
    num, den = 0.0, 0.0
    for m, l, acc in states:  # in rank order
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - mt))
        num = num + w[..., None] * acc
        den = den + w * l
    o = num / torch.clamp(den, min=1e-30)[..., None]
    if return_state:
        return o, torch.where(mt == float("-inf"), tdec.NEG, mt), den
    return o


@pytest.mark.parametrize("edge", KV_EDGES)
@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("mode", ["int4", "bf16"])
def test_split_schedule_matches_jax(mode, group, edge):
    """For every S in 1..8: the state (f32 output, m, l) and the
    k_scale-scaled output against JAX's and against the port's plain
    version; kv_len 0 gives the empty state (0, -1e30, 0), whose m is
    JAX's."""
    kv_len = _kv(edge, mode)
    q, k_s, kt, vt = _inputs(mode, group)
    kt, vt = _torch_kv(kt), _torch_kv(vt)
    tq, tks = torch.from_numpy(q), torch.from_numpy(k_s)
    tile, packed = tdec.TILE[_mode_id(mode)], mode == "int4"
    j_state = _jax_ref(mode, group, kv_len, True)
    j_state = tuple(x.reshape(2, 2, group, *x.shape[3 if group > 1 else 2:]) for x in j_state)
    p_state = tdec.decode_cross_attention_plain(tq * 0.125, kt, vt, kv_len, 1, packed, True)
    qs = tq * 0.125 * tks[:, :, None]
    for splits in range(1, 9):
        got = split_schedule(tq * 0.125, kt, vt, kv_len, 1, packed, splits, tile, True)
        for g_, p in zip(got, p_state):
            torch.testing.assert_close(g_, p, **TOL)
        if kv_len == 0:
            # the empty state; the TPU kernel's l and acc differ there, its m
            # is the same -1e30, so the state weighs 0 in a merge either way
            assert not got[0].any() and (got[1] == -1e30).all() and not got[2].any()
            np.testing.assert_array_equal(got[1].numpy(), j_state[1])
            continue
        for g_, j in zip(got, j_state):
            np.testing.assert_allclose(g_.numpy(), j, **TOL)
        out = split_schedule(qs, kt, vt, kv_len, 1, packed, splits, tile, False)
        ref = _jax_ref(mode, group, kv_len, False).reshape(out.shape)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        plain = tdec.decode_cross_attention_plain(qs, kt, vt, kv_len, 1, packed)
        torch.testing.assert_close(out, plain, **TOL)


def _tiles(t_pad, mode):
    return -(-t_pad // tdec.TILE[mode])


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
def test_choose_splits_stays_in_range(mode, sms):
    """1 <= S <= 8, two or more of T_pad's tiles a CTA where S > 1, and
    with every position live no rank is left without a tile."""
    for pairs in (1, 2, 3, 4, 16, 64, 100, 1024, 2048, 10000):
        for t_pad in (4, 64, 128, 132, 1536, 8192):
            s = tdec.choose_splits(pairs, t_pad, mode, sms)
            tiles = _tiles(t_pad, mode)
            assert 1 <= s <= min(tdec.MAX_SPLITS, tiles)
            assert s == 1 or tiles // s >= 2
            assert (s - 1) * -(-tiles // s) < tiles


@pytest.mark.parametrize("batch,group", [(128, 1), (64, 5)])
def test_choose_splits_is_one_at_the_bench_shapes(batch, group):
    """The JAX bench's greedy batch 128 and beam batch 64 x 5 (the group
    shares its K/V read): batch x 16 heads already fill the card."""
    assert tdec.choose_splits(batch * 16, T_PAD, tdec.PACKED_INT4_MODE, H100_SMS) == 1


def test_choose_splits_keeps_a_short_cache_in_one_cta():
    """The time-minor cache at the main path's last step (bf16, 128
    positions: two 64-position tiles) is not split at batch 4."""
    assert tdec.choose_splits(4 * 16, 128, 2, H100_SMS) == 1


@pytest.mark.parametrize("t_pad", [1536, 8192])
def test_choose_splits_fills_the_card_at_batch_4(t_pad):
    """Batch 4 x 16 heads is 64 pairs on 132 SMs: the cross cache splits
    into S >= 2 CTAs a pair (2 at the main path's 1536 positions, 12
    tiles: 6 a CTA), as many as keep one CTA an SM."""
    s = tdec.choose_splits(4 * 16, t_pad, tdec.PACKED_INT4_MODE, H100_SMS)
    assert s == 2
    assert 4 * 16 * s <= H100_SMS

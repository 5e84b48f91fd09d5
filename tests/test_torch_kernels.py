"""The port's kernels and the deferred-read merge against the JAX functions.

On the CPU each port wrapper runs its plain PyTorch version, and the JAX
function runs its Pallas kernel in interpret mode (``interpret=True``), so
these tests hold the plain versions to the TPU kernels' semantics. Both
sides compute in f32 from the same numpy inputs: the tolerance is f32
summation-order noise (1e-5).

``test_torch_cuda.py`` holds the CUDA kernels against these plain versions
on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from robustsq_whisper_tpu.ops import attention as jatt
from robustsq_whisper_tpu.ops import beam_gather as jbg
from robustsq_whisper_tpu.ops import decode_attention as jdec
from robustsq_whisper_tpu.ops import flash_attention as jflash
from robustsq_whisper_tpu.ops import self_attention as jself
from robustsq_whisper_torch.decode.search import top_k_stable
from robustsq_whisper_torch.ops import attention as tatt
from robustsq_whisper_torch.ops import beam_gather as tbg
from robustsq_whisper_torch.ops import decode_attention as tdec
from robustsq_whisper_torch.ops import flash_attention as tflash
from robustsq_whisper_torch.ops import self_attention as tself

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 vs f32, different summation order


def _rng(seed):
    return np.random.default_rng(seed)


def test_plain_attention_and_masks_match_jax():
    """The port's attention reference: dot_product_attention under a causal
    and a padding mask, and the masks themselves."""
    rng = _rng(0)
    q = rng.standard_normal((2, 5, 3, 16), np.float32)
    k, v = (rng.standard_normal((2, 7, 3, 16), np.float32) for _ in range(2))
    lens = np.array([7, 4], np.int32)
    np.testing.assert_array_equal(
        tatt.causal_mask(5, 7).numpy(), np.asarray(jatt.causal_mask(5, 7))
    )
    j_pad = jatt.padding_mask(jnp.asarray(lens), 7)
    t_pad = tatt.padding_mask(torch.from_numpy(lens), 7)
    np.testing.assert_array_equal(t_pad.numpy(), np.asarray(j_pad))
    for jm, tm in (
        (jatt.causal_mask(5, 7), tatt.causal_mask(5, 7)), (j_pad, t_pad)
    ):
        ref = jatt.dot_product_attention(*map(jnp.asarray, (q, k, v)), mask=jm)
        got = tatt.dot_product_attention(*map(torch.from_numpy, (q, k, v)), mask=tm)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("t_len", [256, 300])
def test_flash_tmaj_plain_matches_jax(t_len):
    rng = _rng(t_len)
    q, k, v = (rng.standard_normal((4, 64, t_len), np.float32) for _ in range(3))
    ref = jflash.flash_attention_tmaj(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True
    )
    got = tflash.flash_attention_tmaj(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_pack_int4_round_trip_and_layout():
    rng = _rng(1)
    q4 = rng.integers(-8, 8, (2, 3, 64, 40)).astype(np.int8)
    packed = tdec.pack_int4(torch.from_numpy(q4))
    assert packed.shape == (2, 3, 32, 40) and packed.dtype == torch.int8
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jdec.pack_int4(jnp.asarray(q4)))
    )
    np.testing.assert_array_equal(tdec.unpack_int4(packed).numpy(), q4)


def _cross_inputs(seed, mode, layers=3, b=2, h=2, d=64, t_pad=512):
    rng = _rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    # K scales keep the scores O(1), as a quantizer's would
    k_s = rng.uniform(0.05, 0.2, (b, h, d)).astype(np.float32)
    if mode == "int8":
        k_s /= 127.0 / 7.0
    shape = (layers, b, h, d, t_pad)
    if mode == "fp":
        kt = rng.standard_normal(shape, np.float32)
        vt = rng.standard_normal(shape, np.float32)
        return q, k_s, kt, vt
    lo, hi = (-8, 8) if mode == "int4" else (-127, 128)
    kt, vt = (rng.integers(lo, hi, shape).astype(np.int8) for _ in range(2))
    if mode == "int4":
        kt, vt = (np.array(jdec.pack_int4(jnp.asarray(x))) for x in (kt, vt))
    return q, k_s, kt, vt


@pytest.mark.parametrize("mode", ["int4", "int8", "fp"])
def test_decode_cross_plain_matches_jax(mode):
    q, k_s, kt, vt = _cross_inputs(7, mode)
    kv_len, layer = 301, 1
    ref = jdec.decode_cross_attention(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(k_s),
        kv_len=jnp.int32(kv_len), layer_idx=jnp.int32(layer),
        interpret=True, packed_int4=mode == "int4",
    )
    got = tdec.decode_cross_attention(
        torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(vt),
        torch.from_numpy(k_s), kv_len=torch.tensor(kv_len, dtype=torch.int32),
        layer_idx=torch.tensor(layer, dtype=torch.int32),
        packed_int4=mode == "int4",
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _self_inputs(seed, layers=2, b=3, t_pad=16, heads=2, n_state=128):
    rng = _rng(seed)
    q, kn, vn = (rng.standard_normal((b, n_state), np.float32) for _ in range(3))
    kc, vc = (
        rng.standard_normal((layers, b, t_pad, n_state), np.float32)
        for _ in range(2)
    )
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_self_plain_matches_jax(pos):
    q, kn, vn, kc, vc = _self_inputs(pos)
    ref = jself.decode_self_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(pos), jnp.int32(1),
        heads=2, interpret=True,
    )
    t = torch.from_numpy
    got = tself.decode_self_attention(
        t(q), t(kn), t(vn), (t(kc), t(vc)), torch.tensor(pos, dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32), heads=2,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if pos == 0:  # nothing cached: exactly the new token's value
        np.testing.assert_array_equal(got.numpy(), vn)


def test_device_scalar_takes_ints_and_tensors():
    """The kernels read kv_len / pos / layer_idx as int32 scalars in device
    memory; a host int or an int64 tensor is converted, an int32 one kept."""
    from robustsq_whisper_torch.ops import _build

    kept = torch.tensor(7, dtype=torch.int32)
    assert _build.device_scalar(kept, "cpu") is kept
    for x in (7, torch.tensor(7)):
        t = _build.device_scalar(x, "cpu")
        assert t.dtype == torch.int32 and int(t) == 7
    with pytest.raises(ValueError, match="scalar"):
        _build.device_scalar(torch.tensor([1, 2]), "cpu")


def test_int8_flat_cache_raises():
    """A three-leaf cache is the int8 form: f32 leaves, or a scale leaf
    that is not bf16 (layers, batch, T, 128), raise instead of reading."""
    q, kn, vn, kc, vc = map(torch.from_numpy, _self_inputs(0))
    with pytest.raises(ValueError, match="int8 flat cache"):
        tself.decode_self_attention(q, kn, vn, (kc, vc, kc), 1, 0, heads=2)
    k8 = kc.to(torch.int8)
    bad_scales = torch.zeros((*k8.shape[:3], 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int8 flat cache"):
        tself.decode_self_attention(q, kn, vn, (k8, k8, bad_scales), 1, 0, heads=2)


@pytest.mark.parametrize(
    "mode,stacked", [("int4", True), ("int8", False), ("fp", True)]
)
def test_grouped_decode_cross_plain_matches_jax(mode, stacked):
    """group 3: each utterance's three beam queries share one K/V; both
    scales fold as (b, h, 1, d)."""
    g = 3
    q, k_s, kt, vt = _cross_inputs(11, mode)
    q = np.stack([q * (1.0 + 0.1 * j) for j in range(g)], axis=2)  # (b, h, g, d)
    v_s = _rng(12).uniform(0.5, 1.5, k_s.shape).astype(np.float32)
    kw = dict(kv_len=301, packed_int4=mode == "int4", group=g)
    if not stacked:
        kt, vt = kt[1], vt[1]
    layer = dict(layer_idx=1) if stacked else {}
    ref = jdec.decode_cross_attention(
        *map(jnp.asarray, (q, kt, vt, k_s, v_s)),
        **{a: jnp.int32(x) for a, x in dict(kv_len=301, **layer).items()},
        packed_int4=mode == "int4", group=g, interpret=True,
    )
    got = tdec.decode_cross_attention(
        *map(torch.from_numpy, (q, kt, vt, k_s, v_s)),
        **{a: torch.tensor(x, dtype=torch.int32) for a, x in layer.items()},
        **kw,
    )
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


SRC_ROWS = {
    "repeats_and_cycles": [3, 0, 0, 5, 2, 1],
    "reversal": [5, 4, 3, 2, 1, 0],
}


@pytest.mark.parametrize("live", [0, 1, 17, 24])
@pytest.mark.parametrize("src", sorted(SRC_ROWS))
def test_beam_reorder_plain_matches_jax(live, src):
    """4-D leaves (layers, rows, T, n_state) of three types, every position
    non-zero: the live 8-chunks (at least one) are permuted, the tail is
    kept as it was. Exact."""
    rng = _rng(live)
    shape = (2, 6, 24, 128)
    f = rng.standard_normal(shape).astype(np.float32)
    i8 = rng.integers(-127, 128, shape).astype(np.int8)
    src_rows = np.array(SRC_ROWS[src], np.int32)
    ref = jbg.beam_reorder_cache(
        [jnp.asarray(f), jnp.asarray(f, jnp.bfloat16), jnp.asarray(i8)],
        jnp.asarray(src_rows), live=jnp.int32(live), time_len=24,
        interpret=True,
    )
    leaves = (
        torch.from_numpy(f.copy()),
        torch.from_numpy(f).bfloat16(),
        torch.from_numpy(i8.copy()),
    )
    got = tbg.beam_reorder_cache(
        leaves, torch.from_numpy(src_rows), live=live, time_len=24
    )
    assert all(g is x for g, x in zip(got, leaves))  # in place
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    p = tbg.live_positions(live, 24)
    assert p == {0: 8, 1: 8, 17: 24, 24: 24}[live]
    np.testing.assert_array_equal(got[0][:, :, p:].numpy(), f[:, :, p:])


def _deferred_inputs(seed, layers=2, rows=6, t_pad=32, heads=2, n_state=128):
    rng = _rng(seed)
    q, kn, vn = (rng.standard_normal((rows, n_state), np.float32) for _ in range(3))
    kc, vc = (
        rng.standard_normal((layers, rows, t_pad, n_state), np.float32)
        for _ in range(2)
    )
    row_map = rng.permutation(rows).astype(np.int32)
    return q, kn, vn, kc, vc, row_map


@pytest.mark.parametrize("settled", [5, 16, 32])
def test_settled_self_plain_matches_jax(settled):
    """Raw (m, l, acc) over [0, settled) of physical row row_map[i]."""
    q, _, _, kc, vc, row_map = _deferred_inputs(settled)
    ref = jself.settled_self_attention(
        jnp.asarray(q), (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(settled),
        jnp.int32(1), jnp.asarray(row_map), heads=2, interpret=True,
    )
    t = torch.from_numpy
    got = tself.settled_self_attention(
        t(q), (t(kc), t(vc)), torch.tensor(settled, dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32), t(row_map), heads=2,
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("settled,pos", [(0, 3), (8, 8), (8, 13), (16, 23)])
def test_deferred_self_attention_matches_jax(settled, pos):
    """Settled state, window state and new token merged; settled = 0 (the
    settled state weighs nothing) and an empty window (pos == settled)
    included."""
    q, kn, vn, kc, vc, row_map = _deferred_inputs(pos)
    window = 8
    ref = jself.deferred_self_attention(
        *map(jnp.asarray, (q, kn, vn)), (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.int32(pos), jnp.int32(settled), jnp.asarray(row_map), jnp.int32(1),
        heads=2, window=window, interpret=True,
    )
    t, i32 = torch.from_numpy, lambda x: torch.tensor(x, dtype=torch.int32)
    got = tself.deferred_self_attention(
        t(q), t(kn), t(vn), (t(kc), t(vc)), i32(pos), i32(settled), t(row_map),
        i32(1), heads=2, window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_ties_break_as_jax(seed):
    """Rows full of equal values (and -1e30 dead-beam scores): the chosen
    indices are jax.lax.top_k's, the lower flat index first."""
    rng = _rng(seed)
    x = rng.integers(0, 4, (3, 40)).astype(np.float32)
    x[:, ::5] = -1e30
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = top_k_stable(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_w8a8_launch_rule_matches_the_c_entry():
    """``launches_per_call`` (by which ``qmatmul`` passes scratch, and which
    the card's counts are held to) is the C entry's rule: one kernel for M
    <= DECODE_ROWS and K <= DECODE_MAX_K, else two; the wrapper's constants
    are the source's."""
    import re

    from robustsq_whisper_torch.ops import _build
    from robustsq_whisper_torch.ops import quant as tq

    src = (_build.CSRC / "w8a8_matmul.cu").read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert tq.DECODE_ROWS == const["DECODE_ROWS"]
    assert "DECODE_MAX_K = MAX_CLUSTER * MAX_SEGS * SEG;" in src
    assert tq.DECODE_MAX_K == const["MAX_CLUSTER"] * const["MAX_SEGS"] * const["SEG"]
    cases = {(1, 16): 1, (4, 1024): 1, (44, 4096): 1, (64, 8192): 1, (65, 1024): 2,
             (6064, 1024): 2, (4, 8208): 2}
    for (m, k), want in cases.items():
        assert tq.launches_per_call(m, k) == want, (m, k)


def test_ctypes_signatures_match_the_c_entry_points():
    """Every extern "C" entry point in csrc/ is declared in _build with its
    parameters in order: pointers (and the stream) as void*, sizes as int.
    A wrong count is a launch-time TypeError or a cut pointer on the card."""
    import ctypes
    import re

    from robustsq_whisper_torch.ops import _build

    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(
            r'extern "C" int (\w+)\((.*?)\)\s*\{', src.read_text(), re.S
        ):
            kinds = [
                ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (x.strip() for x in params.split(","))
            ]
            found[name] = kinds
    assert set(found) == set(_build.SIGNATURES)
    for name, kinds in found.items():
        assert _build.SIGNATURES[name] == kinds, name
    for lib in _build.KERNELS:  # every entry a library declares exists there
        for entry in _build.ENTRIES.get(lib, (lib,)):
            assert entry in found

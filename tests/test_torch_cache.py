"""The self-cache layouts other than the dense flat one, against the JAX
package, on the CPU.

Ops: ``quantize_flat_kv``, the int8 branch of ``decode_self_attention``,
``decode_cross_attention`` with ``return_state``, ``decode_self_attention_tmin``
and the flattened zero-tail ``beam_reorder_cache``. The JAX functions run
their Pallas kernels in interpret mode, the port its plain versions, from
the same numpy inputs.

Modules: ``TextDecoder.prefill`` and ``step`` over the int8 flat, the
time-minor and the 5-D (dense and int8) caches, at M = 1 with a uniform
position and, on the 5-D cache, at M = 1 and M = 3 with per-row positions
(the speculative draft and verify steps). Same flax-initialised weights
(``convert.load_flax``), f32 everywhere.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.ops import beam_gather as jbg
from robustsq_whisper_tpu.ops import decode_attention as jdec
from robustsq_whisper_tpu.ops import quant as jquant
from robustsq_whisper_tpu.ops import self_attention as jself
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.models import TSDecoder, WhisperDims
from robustsq_whisper_torch.ops import beam_gather as tbg
from robustsq_whisper_torch.ops import decode_attention as tdec
from robustsq_whisper_torch.ops import quant as tquant
from robustsq_whisper_torch.ops import self_attention as tself

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 vs f32, different summation order
t, i32 = torch.from_numpy, lambda x: torch.tensor(x, dtype=torch.int32)


def _rng(seed):
    return np.random.default_rng(seed)


def test_quantize_activation_matches_jax():
    """Identical codes and scales: the same f32 ops, rounding half to even."""
    x = _rng(0).standard_normal((3, 5, 2, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    ref = jquant.quantize_activation(jnp.asarray(x))
    got = tquant.quantize_activation(t(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_quantize_flat_kv_matches_jax():
    """Codes clipped to +-127 after the bf16-rounded scale, K scales in
    lanes [0, heads), V's in [heads, 2 heads), zeros after: identical."""
    rng = _rng(1)
    k, v = (rng.standard_normal((2, 3, 5, 256)).astype(np.float32) for _ in range(2))
    k[0, 0, 0, :64] = 0.0  # a zero head takes the 1e-6 floor
    ref = jself.quantize_flat_kv(jnp.asarray(k), jnp.asarray(v), 4)
    got = tself.quantize_flat_kv(t(k), t(v), 4)
    assert [g.dtype for g in got] == [torch.int8, torch.int8, torch.bfloat16]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    assert not got[2][..., 8:].any() and got[0].abs().max() <= 127


def _int8_self_inputs(seed, layers=2, b=3, t_pad=16, heads=2, n_state=128):
    rng = _rng(seed)
    q, kn, vn = (rng.standard_normal((b, n_state)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.standard_normal((layers, b, t_pad, n_state)).astype(np.float32)
              for _ in range(2))
    k8, v8, sc = jself.quantize_flat_kv(jnp.asarray(kc), jnp.asarray(vc), heads)
    return q, kn, vn, (np.array(k8), np.array(v8), np.array(sc))


@pytest.mark.parametrize("pos", [0, 5, 16])
def test_int8_decode_self_plain_matches_jax(pos):
    """The three-leaf branch: K scales after the dot, V scales on the
    weights, the raw weights in the normaliser, the new token exact."""
    q, kn, vn, cache = _int8_self_inputs(pos)
    ref = jself.decode_self_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        tuple(jnp.asarray(c) for c in cache), jnp.int32(pos), jnp.int32(1),
        heads=2, interpret=True,
    )
    tcache = (t(cache[0]), t(cache[1]), t(cache[2].view(np.uint16)).view(torch.bfloat16))
    got = tself.decode_self_attention(
        t(q), t(kn), t(vn), tcache, i32(pos), i32(1), heads=2
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if pos == 0:  # nothing cached: exactly the new token's value
        np.testing.assert_array_equal(got.numpy(), vn)


def _tmin_inputs(seed, layers=2, b=3, heads=2, d=64, t_pad=256):
    rng = _rng(seed)
    q, kn, vn = (rng.standard_normal((b, heads, d)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.standard_normal((layers, b, heads, d, t_pad)).astype(np.float32)
              for _ in range(2))
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("kv_len", [1, 100, 256])
def test_decode_cross_state_plain_matches_jax(kv_len):
    """return_state over stacked dense K/V: the f32 normalised output and
    (m, l); JAX with dynamic_grid (its kernel reads the live chunks only,
    as the port's always does)."""
    q, _, _, kc, vc = _tmin_inputs(kv_len)
    ref = jdec.decode_cross_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), kv_len=jnp.int32(kv_len),
        layer_idx=jnp.int32(1), block_t=128, interpret=True, dynamic_grid=True,
        return_state=True,
    )
    got = tdec.decode_cross_attention(
        t(q), t(kc), t(vc), kv_len=i32(kv_len), layer_idx=i32(1), return_state=True,
    )
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_decode_cross_state_refuses_scales():
    q, _, _, kc, vc = map(t, _tmin_inputs(0))
    with pytest.raises(ValueError, match="return_state"):
        tdec.decode_cross_attention(q, kc, vc, torch.ones(3, 2, 64), kv_len=5,
                                    layer_idx=0, return_state=True)


@pytest.mark.parametrize("pos", [0, 5, 130])
def test_decode_self_tmin_plain_matches_jax(pos):
    """The time-minor read: the cross kernel's state over [0, pos) merged
    with the new token in f32; pos = 0 gives exactly the new token's V
    (the empty state weighs 0)."""
    q, kn, vn, kc, vc = _tmin_inputs(pos + 1)
    ref = jself.decode_self_attention_tmin(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(pos), jnp.int32(1),
        interpret=True,
    )
    got = tself.decode_self_attention_tmin(
        t(q), t(kn), t(vn), (t(kc), t(vc)), i32(pos), i32(1)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if pos == 0:
        np.testing.assert_allclose(got.numpy(), vn, rtol=0, atol=1e-7)


SRC = np.array([3, 0, 0, 5, 2, 1], np.int32)


@pytest.mark.parametrize(
    "t_len,live",
    [(128, 0), (128, 1), (128, 31), (128, 32), (128, 33), (128, 64),
     (128, 128), (512, 256), (512, 257)],
)
def test_flattened_beam_reorder_plain_matches_jax(t_len, live):
    """Leaves that are not (L, rows, T % 8, n % 128): 5-D bf16, int8 and
    f32, and an f32 (L, rows, T, heads) scale leaf, every position
    non-zero. The live chunks of 32 x 128 elements move, the tail comes
    back zero and the input is untouched (out of place). Exact."""
    rng = _rng(live)
    five = (2, 6, t_len, 2, 64)
    f = rng.standard_normal(five).astype(np.float32)
    i8 = rng.integers(-127, 128, five).astype(np.int8)
    sc = rng.uniform(0.5, 1.5, (2, 6, t_len, 4096 // t_len)).astype(np.float32)
    j_in = [jnp.asarray(f, jnp.bfloat16), jnp.asarray(i8), jnp.asarray(f), jnp.asarray(sc)]
    ref = jbg.beam_reorder_cache(
        j_in, jnp.asarray(SRC), live=jnp.int32(live), time_len=t_len, interpret=True,
    )
    leaves = (t(f).bfloat16(), t(i8.copy()), t(f.copy()), t(sc.copy()))
    before = [x.clone() for x in leaves]
    got = tbg.beam_reorder_cache(leaves, t(SRC), live=live, time_len=t_len)
    for g, r, x, b in zip(got, ref, leaves, before):
        assert g is not x and torch.equal(x, b)  # out of place
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
        s_full = x.numel() // (2 * 6 * 128)
        e = tbg.live_rows(live, s_full, t_len) * 128
        flat = g.reshape(2, 6, -1)
        assert not flat[:, :, e:].any()  # the tail is zero
        assert torch.equal(flat[:, :, :e], b.reshape(2, 6, -1)[:, t(SRC).long(), :e])


def test_flattened_beam_reorder_refuses_ragged_payload():
    x = torch.ones(2, 6, 20, 2, 64)  # 20 positions: 20 rows of 128, not 32s
    with pytest.raises(ValueError, match="chunks of 32"):
        tbg.beam_reorder_cache((x,), t(SRC), live=3, time_len=20)


# ---- TextDecoder over each layout ----

DIMS = dict(
    n_mels=80, n_vocab=120, n_audio_ctx=16, n_audio_state=128,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
LAYOUTS = {  # name: decoder flags
    "flat-int8": dict(self_kv_bits=8),
    "tmin": dict(tmin_self_cache=True),
    "5d": dict(flat_self_cache=False),
    "5d-int8": dict(flat_self_cache=False, self_kv_bits=8),
}
B, SOP = 3, 3


@pytest.fixture(scope="module")
def weights():
    rng = _rng(4)
    memory = rng.standard_normal((B, 24, 128)).astype(np.float32)
    prompt = rng.standard_normal((B, 4, 128)).astype(np.float32)
    jdec0 = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    variables = jax.jit(jdec0.init)(
        jax.random.PRNGKey(3), jnp.asarray(memory), jnp.zeros((B, 3), jnp.int32),
        jnp.asarray(prompt),
    )
    return variables, memory, prompt


def _np_leaf(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


STEPS = {  # name: (tokens (B, M), pos: int or per-row list)
    "m1-uniform": ([[7], [9], [11]], 7),
    "m1-ragged": ([[7], [9], [11]], [7, 9, 8]),
    "m3-ragged": ([[7, 5, 6], [9, 9, 4], [11, 3, 8]], [7, 9, 8]),
}


@pytest.mark.parametrize(
    "layout,step",
    [(lay, st) for lay in LAYOUTS for st in STEPS
     if st == "m1-uniform" or lay.startswith("5d")],
)
def test_text_decoder_layout_matches_jax(weights, layout, step):
    """Prefill [sop; prompt; init] (7 positions), then one step of M
    tokens at the given positions, on both sides (a row past 7 reads the
    cache's zeros in between on both): the logits and every cache leaf
    agree. int8 codes may differ by one step where f32 noise moves a value
    across a rounding boundary, bf16 scales by one rounding (2^-8)."""
    variables, memory, prompt = weights
    kw = LAYOUTS[layout]
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw)
    td = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP,
                             cross_kv_bits=4, **kw), variables).eval()
    init = np.tile(np.array([[1, 2]], np.int32), (B, 1))
    toks, pos = STEPS[step]
    toks = np.array(toks, np.int32)
    m = lambda meth, *a: jax.jit(lambda v, *x: jd.apply(v, *x, method=meth))(variables, *a)
    j_cross = m(JDec.cross_kv, jnp.asarray(memory))
    j_cache = jd.apply(variables, B, 24, method=JDec.init_cache)
    j_pre, j_cache = m(JDec.prefill, jnp.asarray(init), jnp.asarray(prompt), j_cache, j_cross)
    j_cross = m(JDec.quantize_cross, j_cross)
    j_step, j_cache = m(JDec.step, jnp.asarray(toks), jnp.asarray(pos, jnp.int32),
                        j_cache, j_cross)
    with torch.inference_mode():
        t_cross = td.cross_kv(t(memory))
        t_cache = td.init_cache(B, 24)
        t_pre, t_cache = td.prefill(t(init).long(), t(prompt), t_cache, t_cross)
        t_step, t_cache = td.step(t(toks).long(), torch.tensor(pos, dtype=torch.int32),
                                  t_cache, td.quantize_cross(t_cross))
    assert td.decoder._cache_layout(t_cache) == layout.split("-")[0]
    np.testing.assert_allclose(t_pre.numpy(), _np_leaf(j_pre), rtol=1e-4, atol=1e-4)
    assert tuple(t_step.shape) == j_step.shape
    np.testing.assert_allclose(t_step.numpy(), _np_leaf(j_step), rtol=1e-4, atol=1e-4)
    assert len(t_cache) == len(j_cache)
    for g, r in zip(t_cache, j_cache):
        assert tuple(g.shape) == r.shape
        if g.dtype == torch.int8:
            diff = np.abs(g.numpy().astype(int) - np.asarray(r).astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99
        else:
            rtol = 8e-3 if g.dtype == torch.bfloat16 else 1e-3
            np.testing.assert_allclose(g.float().numpy(), _np_leaf(r), rtol=rtol, atol=1e-4)

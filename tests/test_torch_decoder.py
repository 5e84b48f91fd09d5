"""The port's decoder-side modules and frontend against the JAX
package's, on the CPU.

Each JAX module is initialised by flax, its variables go through the
port's ``convert.flax_to_state_dict`` into the torch twin, and both get the
same numpy inputs. JAX runs its Pallas kernels in interpret mode (the
modules pick it on the CPU), the port runs their plain versions. Everything
is f32: tolerances are f32 summation-order noise grown through the layers
(stated per test).

Dims are small but keep the main path's routes: the decoder's
n_text_state 128 with 2 heads keeps the flat self cache.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.audio import frontend as jfront
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.models.whisper import modules as jmod
from robustsq_whisper_torch.audio import frontend as tfront
from robustsq_whisper_torch.convert import flax_to_state_dict, load_flax
from robustsq_whisper_torch.models import TSDecoder, WhisperDims
from robustsq_whisper_torch.models.whisper import modules as tmod

from ._waves import edge_wave


DIMS = dict(
    n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128,
    n_audio_head=2, n_audio_layer=2, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
SOP = 3  # <|startofprev|> inside the small vocab
B = 2


def _np(x):
    return np.asarray(x, np.float32)


def _leaf_count(variables):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables))


@pytest.fixture(scope="module")
def dec_pair():
    jdec = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    rng = np.random.default_rng(0)
    memory = jnp.asarray(rng.standard_normal((1, 8, 128)), jnp.float32)
    prompt = jnp.asarray(rng.standard_normal((1, 4, 128)), jnp.float32)
    ys = jnp.zeros((1, 3), jnp.int32)
    variables = jax.jit(jdec.init)(jax.random.PRNGKey(1), memory, ys, prompt)
    tdec = load_flax(
        TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4),
        variables,
    )
    return jdec, variables, tdec.eval()


def test_bridge_consumes_every_leaf(dec_pair):
    """Every flax leaf lands in exactly one torch tensor and the state dict
    loads strictly (the fixture already loaded it with strict=True)."""
    _, variables, module = dec_pair
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(module.state_dict())
    assert sum(t.numel() for t in sd.values()) == _leaf_count(variables)
    module.load_state_dict(sd, strict=True)


def test_quantize_kv_tensors_matches_jax():
    """Same f32 elementwise ops on the same K/V: identical codes; scales and
    zero-points to f32 rounding."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 3, 37, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 3, 37, 2, 64)).astype(np.float32)
    for bits in (4, 8):
        ref = jmod.quantize_kv_tensors(jnp.asarray(k), jnp.asarray(v), bits=bits)
        got = tmod.quantize_kv_tensors(torch.from_numpy(k), torch.from_numpy(v), bits=bits)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            if g.dtype == torch.int8 or g.dtype == torch.int32:
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            else:
                np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-6, atol=1e-7)


def _decoder_state(dec_pair, quantize):
    """Prefill [sop; prompt; init] on both sides, then one step on the
    quantized (or dense) cross K/V. Returns (jax, torch) of every stage."""
    jdec, variables, tdec = dec_pair
    rng = np.random.default_rng(11)
    memory = rng.standard_normal((B, 30, 128)).astype(np.float32)
    prompt = rng.standard_normal((B, 4, 128)).astype(np.float32)
    init = np.tile(np.array([[1, 2]], np.int32), (B, 1))
    m = lambda meth, *a: jax.jit(
        lambda v, *x: jdec.apply(v, *x, method=meth)
    )(variables, *a)
    j_cross = m(JDec.cross_kv, jnp.asarray(memory))
    j_cache = jdec.apply(variables, B, 16, method=JDec.init_cache)
    j_logits, j_cache = m(JDec.prefill, jnp.asarray(init), jnp.asarray(prompt), j_cache, j_cross)
    if quantize:
        j_cross = m(JDec.quantize_cross, j_cross)
    tok = np.array([[7], [9]], np.int32)
    j_step, j_cache2 = m(JDec.step, jnp.asarray(tok), jnp.int32(7), j_cache, j_cross)
    with torch.inference_mode():
        t_cross = tdec.cross_kv(torch.from_numpy(memory))
        t_cache = tdec.init_cache(B, 16)
        t_logits, t_cache = tdec.prefill(
            torch.from_numpy(init).long(), torch.from_numpy(prompt), t_cache, t_cross
        )
        t_pref_cache = tuple(c.clone() for c in t_cache)
        if quantize:
            t_cross_q = tdec.quantize_cross(t_cross)
        t_step, t_cache2 = tdec.step(
            torch.from_numpy(tok).long(), torch.tensor(7, dtype=torch.int32),
            t_cache, t_cross_q if quantize else t_cross,
        )
    out = dict(
        cross=(j_cross, t_cross_q if quantize else t_cross),
        prefill=(j_logits, t_logits), pref_cache=(j_cache, t_pref_cache),
        step=(j_step, t_step), cache=(j_cache2, t_cache2),
    )
    return out


@pytest.mark.parametrize("quantize", [False, True])
def test_text_decoder_prefill_and_step_match_jax(dec_pair, quantize):
    st = _decoder_state(dec_pair, quantize)
    j_cross, t_cross = st["cross"]
    for j, t in zip(j_cross, t_cross):
        assert tuple(t.shape) == tuple(j.shape)
        if t.dtype in (torch.int8, torch.int32):
            # codes of K/V that agree to f32 rounding; a flip at an exact
            # rounding boundary would show as a difference of one step
            assert np.abs(t.numpy().astype(int) - np.asarray(j).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), _np(j), rtol=1e-5, atol=1e-5)
    # f32 through 2 decoder layers and the tied-embedding logits
    for key in ("prefill", "step"):
        j, t = st[key]
        assert tuple(t.shape) == (B, DIMS["n_vocab"])
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=1e-4, atol=1e-4)
    for key in ("pref_cache", "cache"):
        for j, t in zip(*st[key]):
            assert tuple(t.shape) == tuple(j.shape)  # flat (L, b, T_pad, n)
            np.testing.assert_allclose(t.numpy(), _np(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])  # 128: large-v3 and large-v3-turbo
def test_log_mel_matches_jax(n_mels):
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    audio[1, 9000:] = 0.0  # a padded tail hits the floor
    lens = np.array([16000, 9000], np.int32)
    ref, ref_l = jfront.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(lens), n_mels)
    got, got_l = tfront.log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(lens), n_mels)
    assert got.shape == (2, n_mels, 100)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    # FFT vs the JAX DFT matmul in f32, through log10
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("rows,width,lens_dtype", [
    (3, 16000, np.int32),  # speech-like
    (2, 4800, np.int64),   # enrollment-like, another width and lengths' dtype
])
def test_device_frontend_equals_host_pcm16_path(n_mels, rows, width, lens_dtype):
    """``pcm16_log_mel``'s features and frame counts are those of the host
    int16 path, bit for bit, and its quantizer is ``to_pcm16`` then
    ``pcm16_to_float`` to the bit (a rounded small negative reads +0.0),
    the port's and the JAX package's. The features are the JAX frontend's
    on the same int16 samples within its FFT-versus-DFT-matmul tolerance
    (``test_log_mel_matches_jax``). The caller's waveform is left as it was."""
    for seed in (0, 1):
        wave = edge_wave(rows, width, seed)
        lens = np.array([width - 37 * i for i in range(rows)], lens_dtype)
        lens[-1] = width // 2
        x = tfront.pcm16_to_float(torch.from_numpy(tfront.to_pcm16(wave)))
        jx = jfront.pcm16_to_float(jnp.asarray(jfront.to_pcm16(wave)))
        np.testing.assert_array_equal(np.asarray(jx).view(np.int32), x.numpy().view(np.int32))
        np.testing.assert_array_equal(
            tfront.quantize_pcm16_(torch.from_numpy(wave.copy())).numpy().view(np.int32),
            x.numpy().view(np.int32),
        )
        ref, ref_l = tfront.log_mel_spectrogram(x, torch.from_numpy(lens), n_mels)
        jref, jref_l = jfront.log_mel_spectrogram(jx, jnp.asarray(lens), n_mels)
        before = wave.copy()
        got, got_l = tfront.pcm16_log_mel(wave, lens, n_mels, "cpu")
        np.testing.assert_array_equal(wave, before)
        assert got.shape == (rows, n_mels, width // 160) and got_l.dtype == ref_l.dtype
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        np.testing.assert_array_equal(got_l.numpy(), ref_l.numpy())
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(jref_l))
        np.testing.assert_allclose(got.numpy(), _np(jref), rtol=1e-4, atol=1e-4)
    assert tfront.pcm16_log_mel.staged == 0  # nothing is pinned off CUDA


def test_pcm16_and_pad_or_trim_match_jax():
    rng = np.random.default_rng(4)
    audio = rng.uniform(-1.2, 1.2, 1000).astype(np.float32)
    i16 = tfront.to_pcm16(audio)
    np.testing.assert_array_equal(i16, jfront.to_pcm16(audio))
    np.testing.assert_array_equal(
        tfront.pcm16_to_float(torch.from_numpy(i16)).numpy(),
        np.asarray(jfront.pcm16_to_float(jnp.asarray(i16))),
    )
    x = rng.standard_normal((2, 50)).astype(np.float32)
    for n in (30, 50, 70):
        np.testing.assert_array_equal(
            tfront.pad_or_trim(torch.from_numpy(x), n).numpy(),
            np.asarray(jfront.pad_or_trim(jnp.asarray(x), n)),
        )

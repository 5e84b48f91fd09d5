"""The port's encoder-side modules against the JAX package's, on the CPU.

Each JAX module is initialised by flax, its variables go through the
port's ``convert.flax_to_state_dict`` into the torch twin, and both get the
same numpy inputs. JAX runs its Pallas kernels in interpret mode (the
modules pick it on the CPU), the port runs their plain versions. Everything
is f32: tolerances are f32 summation-order noise grown through the layers
(stated per test).

Dims are small but keep the main path's route: 512 mel frames give 256
encoder positions, so both encoders take the transposed flash route
(``use_flash_attention`` + ``flash_tmaj``, T >= 256).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.models import QFormerTSEncoder as JEnc
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_torch.convert import flax_to_state_dict, load_flax
from robustsq_whisper_torch.models import QFormerTSEncoder
from robustsq_whisper_torch.models import TSEncoderConfig, WhisperDims

DIMS = dict(
    n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128,
    n_audio_head=2, n_audio_layer=2, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
TS = dict(
    num_query_tokens=4, num_hidden_layers=2, qformer_hidden_size=64,
    qformer_heads=2, qformer_intermediate_size=128,
    use_flash_attention=True, flash_tmaj=True, gelu_approx=True,
)
B, FRAMES, E_FRAMES = 2, 512, 120


def _np(x):
    return np.asarray(x, np.float32)


def _leaf_count(variables):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables))


@pytest.fixture(scope="module")
def enc_pair():
    jenc = JEnc(JDims(**DIMS), JTS(**TS))
    mel = jnp.zeros((1, 80, 20), jnp.float32)
    variables = jax.jit(lambda k, m: jenc.init(k, m, None, m, None))(jax.random.PRNGKey(0), mel)
    tenc = load_flax(QFormerTSEncoder(WhisperDims(**DIMS), TSEncoderConfig(**TS)), variables)
    return jenc, variables, tenc.eval()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, 80, FRAMES)).astype(np.float32)
    emel = rng.standard_normal((B, 80, E_FRAMES)).astype(np.float32)
    return mel, np.array([FRAMES, 401], np.int32), emel, np.array([E_FRAMES, 77], np.int32)


def test_bridge_consumes_every_leaf(enc_pair):
    """Every flax leaf lands in exactly one torch tensor and the state dict
    loads strictly (the fixture already loaded it with strict=True)."""
    _, variables, module = enc_pair
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(module.state_dict())
    assert sum(t.numel() for t in sd.values()) == _leaf_count(variables)
    module.load_state_dict(sd, strict=True)


def test_audio_encoder_matches_jax(enc_pair):
    jenc, variables, tenc = enc_pair
    mel = _inputs(0)[0]
    ref = jax.jit(lambda v, x: jenc.apply(v, x, method=lambda m, x: m.encoder(x)))(variables, jnp.asarray(mel))
    with torch.inference_mode():
        got = tenc.encoder(torch.from_numpy(mel))
    # f32 through the conv stem and 2 blocks
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)


def test_qformer_matches_jax(enc_pair):
    jenc, variables, tenc = enc_pair
    rng = np.random.default_rng(3)
    mem = rng.standard_normal((B, 40, 128)).astype(np.float32)
    enr = rng.standard_normal((B, 30, 128)).astype(np.float32)
    ml, el = np.array([40, 25], np.int32), np.array([30, 11], np.int32)
    ref = jax.jit(
        lambda v, *a: jenc.apply(v, *a, method=lambda m, *a: m.qformer(*a))
    )(variables, *map(jnp.asarray, (mem, ml, enr, el)))
    with torch.inference_mode():
        got = tenc.qformer(*map(torch.from_numpy, (mem, ml, enr, el)))
    for g, r in zip(got, ref):  # f32, 2 post-LN layers
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-4, atol=1e-4)


def test_ts_encoder_matches_jax(enc_pair):
    jenc, variables, tenc = enc_pair
    inputs = _inputs(1)
    ref = jax.jit(jenc.apply)(variables, *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got = tenc(*map(torch.from_numpy, inputs))
    assert got[0].shape == (B, TS["num_query_tokens"] + FRAMES // 2, 128)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for i in (0, 2, 3):  # f32, Qformer + 2 encoder blocks deep
        np.testing.assert_allclose(got[i].numpy(), _np(ref[i]), rtol=1e-4, atol=1e-4)

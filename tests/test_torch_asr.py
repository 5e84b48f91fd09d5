"""The port's zero-shot ``WhisperASR`` against the JAX package's on the CPU.

A random-weight OpenAI-format ``.pt`` (written by the JAX package's own
test helper) gives the weights; the port takes them two ways: JAX's
variables of the file bridged with ``convert.load_flax``, and the file read
by the port's ``from_openai_checkpoint``. The same seeded audio (3 s, padded
to the 30 s window) goes through both; JAX runs its self-cache and reorder
kernels in interpret mode, the port their plain versions. Tokens must be
identical, greedy and beam 3, and the scores agree to 1e-4 (f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robustsq_whisper_tpu.models.asr import WhisperASR as JASR
from robustsq_whisper_tpu.models.whisper import WhisperDims as JDims
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.models.asr import WhisperASR
from robustsq_whisper_torch.models.whisper.modules import AudioEncoder

from tests.test_openai_checkpoint import _make_openai_pt

SMALL = dict(n_vocab=64, n_audio_state=128, n_audio_layer=1, n_text_state=128,
             n_text_ctx=64)
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(0).standard_normal((2, 16000 * 3)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def models(tmp_path_factory, audio):
    """A random-weight OpenAI ``.pt``; JAX's ``WhisperASR`` of it and its
    tokens and scores, greedy and beam 3; and the port's two models of the
    same weights: JAX's variables bridged with ``load_flax``, and the file
    read by the port's own loader."""
    dims = JDims(n_mels=80, n_audio_ctx=1500, n_audio_head=2, n_text_head=2,
                 n_text_layer=2, **SMALL)
    path = str(tmp_path_factory.mktemp("asr") / "small.pt")
    _make_openai_pt(path, dims)
    jasr = JASR.from_openai_checkpoint(path)
    want = {beam: tuple(np.asarray(x) for x in jasr.transcribe_batch(
        jnp.asarray(audio), max_new_tokens=MAX_NEW, beam_size=beam)) for beam in (1, 3)}
    enc, dec = WhisperASR.build(jasr.dims)
    ports = {
        "converted": WhisperASR(jasr.dims, load_flax(enc, jasr.enc_vars),
                                load_flax(dec, jasr.dec_vars), device="cpu"),
        "openai": WhisperASR.from_openai_checkpoint(path, device="cpu"),
    }
    return want, ports


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("source", ["converted", "openai"])
def test_transcribe_equals_jax(models, audio, source, beam):
    want, ports = models
    asr = ports[source]
    p_tok, p_sc = asr.transcribe_batch(torch.from_numpy(audio), max_new_tokens=MAX_NEW,
                                       beam_size=beam)
    assert p_tok.shape == (2, MAX_NEW) and p_tok.dtype == torch.int32
    np.testing.assert_array_equal(p_tok.numpy(), want[beam][0])
    np.testing.assert_allclose(p_sc.numpy(), want[beam][1], rtol=1e-4, atol=1e-4)
    # the loader keeps the encoder's computed sinusoids
    assert torch.equal(asr.encoder.positional_embedding,
                       AudioEncoder(asr.dims).positional_embedding)


def test_from_random_and_device(monkeypatch):
    """The seeded init is deterministic and its weights tied to the seed;
    the default device is the card, which raises without CUDA."""
    a = WhisperASR.from_random("dev", seed=1, device="cpu", **SMALL)
    b = WhisperASR.from_random("dev", seed=1, device="cpu", **SMALL)
    c = WhisperASR.from_random("dev", seed=2, device="cpu", **SMALL)
    w = lambda m: m.decoder.decoder.blocks[0].attn.query.weight
    assert torch.equal(w(a), w(b)) and not torch.equal(w(a), w(c))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WhisperASR.from_random("dev", seed=1, **SMALL)

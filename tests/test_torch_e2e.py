"""The port's whole slice against the JAX package.

Greedy decode must give the JAX decoder's tokens exactly, for both
``prefill_quantized`` settings, and ``TranscriptionEngine.transcribe`` the
JAX engine's strings, greedy and with beam 3, from the same weights (flax
init, converted) and the same numpy inputs, on the CPU (JAX runs its
Pallas kernels in interpret mode, the port the kernels' plain versions).
The seeds give top-2 logit margins far above the f32 noise of the two
sides, so the tokens can be compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.decode.search import build_greedy_decoder as j_greedy
from robustsq_whisper_tpu.models import QFormerTSEncoder as JEnc
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.serve import EngineConfig as JEngineConfig
from robustsq_whisper_tpu.serve import TranscriptionEngine as JEngine
from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import ByteTokenizer as JByte
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode.search import DecodeConfig, build_greedy_decoder
from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder
from robustsq_whisper_torch.models import TSEncoderConfig, WhisperDims
from robustsq_whisper_torch.serve import EngineConfig, TranscriptionEngine
from robustsq_whisper_torch.tokenizer import ByteTokenizer

DIMS = dict(
    n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128,
    n_audio_head=2, n_audio_layer=2, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
TS = dict(
    num_query_tokens=4, num_hidden_layers=1, qformer_hidden_size=64,
    qformer_heads=2, qformer_intermediate_size=128,
    use_flash_attention=True, flash_tmaj=True, gelu_approx=True,
)
SOP, EOT = 3, 2
DCFG = dict(
    max_new_tokens=8, min_new_tokens=2, eot=EOT, init_tokens=(1, 4),
    quantize_cross_kv=True, stop_early=True,
)


@pytest.fixture(scope="module")
def decoders():
    jdec = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    rng = np.random.default_rng(0)
    memory = jnp.asarray(rng.standard_normal((1, 8, 128)), jnp.float32)
    prompt = jnp.asarray(rng.standard_normal((1, 4, 128)), jnp.float32)
    dvars = jax.jit(jdec.init)(
        jax.random.PRNGKey(2), memory, jnp.zeros((1, 3), jnp.int32), prompt
    )
    tdec = load_flax(
        TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4),
        dvars,
    )
    return jdec, dvars, tdec


@pytest.mark.parametrize("prefill_quantized", [False, True])
def test_greedy_tokens_identical_to_jax(decoders, prefill_quantized):
    jdec, dvars, tdec = decoders
    rng = np.random.default_rng(21)
    memory = rng.standard_normal((3, 260, 128)).astype(np.float32)
    prompt = rng.standard_normal((3, 4, 128)).astype(np.float32)
    kw = dict(DCFG, prefill_quantized=prefill_quantized)
    j_tok, j_score = j_greedy(jdec, dvars, JDecodeConfig(**kw))(
        jnp.asarray(memory), jnp.asarray(prompt)
    )
    run = build_greedy_decoder(tdec, DecodeConfig(**kw), device="cpu")
    t_tok, t_score = run(torch.from_numpy(memory), torch.from_numpy(prompt))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert len(set(np.asarray(j_tok).ravel().tolist())) > 2  # not degenerate
    # summed log-probs, f32 through the decoder
    np.testing.assert_allclose(t_score.numpy(), np.asarray(j_score), rtol=1e-4, atol=1e-4)


def _engine_strings(decoders, dcfg):
    """(JAX strings, port strings) of one batch through both engines."""
    jdec, dvars, tdec = decoders
    jenc = JEnc(JDims(**DIMS), JTS(**TS))
    mel = jnp.zeros((1, 80, 20), jnp.float32)
    evars = jax.jit(lambda k, m: jenc.init(k, m, None, m, None))(
        jax.random.PRNGKey(0), mel
    )
    tenc = load_flax(QFormerTSEncoder(WhisperDims(**DIMS), TSEncoderConfig(**TS)), evars)
    # 5.12 s of speech = 512 mel frames = the model's 256 encoder positions
    ecfg = dict(batch_size=2, speech_seconds=5.12, enroll_seconds=0.75)
    j_engine = JEngine(
        jenc, evars, jdec, dvars, JByte(), JDecodeConfig(**dcfg),
        JEngineConfig(**ecfg),
    )
    t_engine = TranscriptionEngine(
        tenc, tdec, ByteTokenizer(), DecodeConfig(**dcfg), EngineConfig(**ecfg),
        device="cpu",
    )
    rng = np.random.default_rng(8)
    items = [
        ((rng.standard_normal(n) * 0.1).astype(np.float32),
         (rng.standard_normal(m) * 0.1).astype(np.float32))
        for n, m in ((80000, 12000), (30000, 9000))
    ]
    return j_engine.transcribe(items), t_engine.transcribe(items)


def test_engine_transcribes_like_jax(decoders):
    ref, got = _engine_strings(decoders, DCFG)
    assert got == ref
    assert any(ref)  # the byte tokenizer decoded something


def test_beam_engine_transcribes_like_jax(decoders):
    """Beam 3 through the engine: the decoder returns the best beam of
    each utterance, so the engine's strings are the JAX engine's."""
    ref, got = _engine_strings(decoders, dict(DCFG, beam_size=3))
    assert got == ref
    assert any(ref)

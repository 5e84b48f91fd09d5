"""The port's beam search against the JAX package's ``build_beam_decoder``.

Same flax-initialised weights (converted with ``load_flax``) and the same
numpy encoder memory and speaker prompt go through both decoders on the
CPU: JAX runs its Pallas kernels in interpret mode, the port the kernels'
plain versions. The best hypotheses must be token-identical and their
scores agree to 1e-4 (f32 summed log-probs through the decoder).

The prompt makes the prefix 12 positions long, so the deferred reorder's
first window starts at 8 and flushes of a non-empty settled prefix happen
within the 16 decoded tokens for every flush period tested.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.decode.search import build_beam_decoder as j_beam
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder
from robustsq_whisper_torch.models import TSDecoder, WhisperDims

DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=2,
)
SOP, EOT = 3, 2
BASE = dict(max_new_tokens=16, eot=EOT, init_tokens=(1, 4), beam_size=3)


@pytest.fixture(scope="module")
def decoders():
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((2, 40, 128)).astype(np.float32)
    prompt = rng.standard_normal((2, 9, 128)).astype(np.float32)
    jdec = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    dvars = jax.jit(jdec.init)(
        jax.random.PRNGKey(5), jnp.asarray(memory), jnp.zeros((2, 4), jnp.int32),
        jnp.asarray(prompt),
    )
    tdec = load_flax(
        TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4),
        dvars,
    )
    return jdec, dvars, tdec, memory, prompt


def _both(decoders, **kw):
    jdec, dvars, tdec, memory, prompt = decoders
    cfg = dict(BASE, **kw)
    j_tok, j_score = j_beam(jdec, dvars, JDecodeConfig(**cfg))(
        jnp.asarray(memory), jnp.asarray(prompt)
    )
    run = build_beam_decoder(tdec, DecodeConfig(**cfg), device="cpu")
    t_tok, t_score = run(torch.from_numpy(memory), torch.from_numpy(prompt))
    return (np.asarray(j_tok), np.asarray(j_score)), (t_tok.numpy(), t_score.numpy())


def _assert_same(ref, got):
    (j_tok, j_score), (t_tok, t_score) = ref, got
    assert t_tok.shape == (2, BASE["max_new_tokens"]) and t_tok.dtype == np.int32
    np.testing.assert_array_equal(t_tok, j_tok)
    assert len(set(j_tok.ravel().tolist())) > 2  # not degenerate
    np.testing.assert_allclose(t_score, j_score, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),  # dense cross K/V, beam-expanded
        dict(quantize_cross_kv=True),  # int4 cross shared by the grouped kernel
        dict(quantize_cross_kv=True, prefill_quantized=True),
        # eot 49 ends beams at different lengths: the eot mask of the first
        # 5 steps, the length penalty and lengths counted along each beam's
        # lineage (not per beam slot) each change the best hypothesis
        dict(quantize_cross_kv=True, eot=49, min_new_tokens=5, length_penalty=2.0),
        dict(quantize_cross_kv=True, stop_early=False),
        dict(quantize_cross_kv=True, beam_reorder="take"),
    ],
    ids=["dense", "int4", "int4-prefill-quantized", "min-new-length-penalty",
         "fixed-length", "take"],
)
def test_beam_tokens_identical_to_jax(decoders, kw):
    _assert_same(*_both(decoders, **kw))


@pytest.mark.parametrize("period", [1, 4, 16])
def test_deferred_beam_tokens_identical_to_jax(decoders, period):
    """defer_reorder rounds to R = 8, 8, 16: the settled prefix is read
    through the row map and flushed with the reorder kernel every R steps."""
    ref, got = _both(decoders, quantize_cross_kv=True, defer_reorder=period)
    _assert_same(ref, got)
    assert EOT not in ref[0][:, :13].ravel().tolist()  # the flushes ran


def test_deferred_beam_rejects_nonflat_dims():
    """Dims whose flat cache cannot tile 128 lanes cannot take the deferred
    reorder: a ValueError at build time, as JAX raises at trace time."""
    dims = WhisperDims(**dict(DIMS, n_audio_state=64, n_text_state=64))
    cfg = DecodeConfig(**dict(BASE, defer_reorder=8))
    with pytest.raises(ValueError, match="dense flat self cache"):
        build_beam_decoder(TSDecoder(dims, startofprev_token=SOP), cfg, device="cpu")

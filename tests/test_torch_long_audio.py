"""The port's long-audio decode against the JAX package's on the CPU.

A tiny target-speaker encoder and decoder, flax-initialised and bridged
with ``convert.load_flax``, with a positional budget of 0.32 s so that
second-long audio spans several windows. JAX runs its kernels in interpret
mode, the port their plain versions (f32). ``chunk_waveform`` must give
the same arrays, ``decode_long_audio`` the same spliced tokens, and
``decode_dataset_long`` the same ``text`` file, byte for byte.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.data import simulate
from robustsq_whisper_tpu.data.dataset import KaldiTSDataset as JDataset
from robustsq_whisper_tpu.decode import long_audio as jlong
from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.models import QFormerTSEncoder as JEnc
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import ByteTokenizer as JByte
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.data.dataset import KaldiTSDataset
from robustsq_whisper_torch.decode import long_audio as plong
from robustsq_whisper_torch.decode.search import DecodeConfig
from robustsq_whisper_torch.models import (
    QFormerTSEncoder, TSDecoder, TSEncoderConfig, WhisperDims,
)
from robustsq_whisper_torch.tokenizer import ByteTokenizer

from tests.test_pipeline import _make_clean_dir

DIMS = dict(n_mels=80, n_vocab=300, n_audio_ctx=16, n_audio_state=128, n_audio_head=2,
            n_audio_layer=1, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2)
TS = dict(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32, qformer_heads=2,
          qformer_intermediate_size=64)
CHUNK_S = 16 * 2 * 160 / 16000  # the positional budget, 0.32 s
CFG = dict(max_new_tokens=5, eot=258, init_tokens=(257,), quantize_cross_kv=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [75, 60, 7, 31, 0])
def test_chunk_waveform_equals_jax(n):
    wav = np.arange(n, dtype=np.float32)
    got = plong.chunk_waveform(wav, chunk_seconds=30, sample_rate=1)
    want = jlong.chunk_waveform(wav, chunk_seconds=30, sample_rate=1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jenc = JEnc(JDims(**DIMS), JTS(**TS))
    jdec = JDec(JDims(**DIMS), startofprev_token=259, cross_kv_bits=4)
    feats = jnp.asarray(rng.standard_normal((2, 80, 32)), jnp.float32)
    efeats = jnp.asarray(rng.standard_normal((2, 80, 16)), jnp.float32)

    @jax.jit
    def init():
        enc_vars = jenc.init(jax.random.PRNGKey(0), feats, None, efeats, None)
        memory, _, prompt, _ = jenc.apply(enc_vars, feats, None, efeats, None)
        # a larger memory and prompt keep the random decoder off one token
        return enc_vars, jdec.init(jax.random.PRNGKey(1), memory * 3,
                                   jnp.zeros((2, 4), jnp.int32), prompt * 3)

    enc_vars, dec_vars = init()
    enc = load_flax(QFormerTSEncoder(WhisperDims(**DIMS), TSEncoderConfig(**TS)), enc_vars)
    dec = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=259, cross_kv_bits=4),
                    dec_vars)
    # JAX's decode_long_audio applies the encoder as given: jit it once
    jitted = types.SimpleNamespace(dims=jenc.dims, apply=jax.jit(jenc.apply))
    return (jitted, enc_vars, jdec, dec_vars), (enc, dec)


def test_decode_long_audio_equals_jax(models):
    """2.5 windows of audio, one enrollment: the spliced tokens are JAX's."""
    rng = np.random.default_rng(3)
    wav = rng.standard_normal(int(2.5 * CHUNK_S * 16000)).astype(np.float32) * 0.1
    enroll = rng.standard_normal(int(0.5 * CHUNK_S * 16000)).astype(np.float32) * 0.1
    want = jlong.decode_long_audio(*models[0], wav, enroll, JDecodeConfig(**CFG),
                                   chunk_seconds=CHUNK_S)
    got = plong.decode_long_audio(*models[1], wav, enroll, DecodeConfig(**CFG),
                                  chunk_seconds=CHUNK_S, device="cpu")
    assert got == want and len(got) > 3


def test_decode_dataset_long_equals_jax(models, tmp_path):
    """A data dir of three second-long mixtures, two targets each (four
    windows an utterance, decoded three windows a batch, then one): ``text``
    byte for byte, though JAX pads the one-window batch with two silent
    windows (one compiled shape) and the port decodes it alone; the
    positional budget is checked."""
    src = _make_clean_dir(tmp_path, n_speakers=2, utts_per_spk=2)
    data_dir = str(tmp_path / "mix")
    simulate.generate_overlap_enrollment(src, data_dir, simulate.OverlapConfig(num_mixtures=3,
                                                                                seed=0))
    kw = dict(speech_seconds=CHUNK_S, enroll_seconds=CHUNK_S / 2, seed=0)
    jds, pds = JDataset(data_dir, JByte(), **kw), KaldiTSDataset(data_dir, ByteTokenizer(), **kw)
    out = {k: str(tmp_path / k) for k in ("jax", "port")}
    jres = jlong.decode_dataset_long(*models[0], jds, JByte(), JDecodeConfig(**CFG),
                                     chunk_seconds=CHUNK_S, output_dir=out["jax"],
                                     window_batch=3, pad_windows_to=3)
    pres = plong.decode_dataset_long(*models[1], pds, ByteTokenizer(), DecodeConfig(**CFG),
                                     chunk_seconds=CHUNK_S, output_dir=out["port"],
                                     window_batch=3, device="cpu")
    with open(os.path.join(out["jax"], "text"), "rb") as f, \
            open(os.path.join(out["port"], "text"), "rb") as g:
        assert g.read() == f.read()
    assert pres.hyps == jres.hyps and len(pres.hyps) == 6 and any(pres.hyps.values())
    assert pres.audio_seconds == jres.audio_seconds > 3 * CHUNK_S
    with pytest.raises(ValueError, match="positional budget"):
        plong.decode_dataset_long(*models[1], pds, ByteTokenizer(), DecodeConfig(**CFG),
                                  chunk_seconds=CHUNK_S * 2, device="cpu")

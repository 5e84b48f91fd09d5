"""The port's Whisper timestamp rules and timestamped greedy decode against
the JAX package's on the CPU.

The rules take the same seeded logits and per-row states on both sides.
Greedy decode runs over flax-initialised weights (``convert.load_flax``)
with the quantized cross K/V and the flat self cache: JAX runs its kernels
in interpret mode, the port their plain versions. Tokens and segments must
be identical and the summed log-probs agree to 1e-4 (f32).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode import timestamps as jts
from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.decode.search import build_greedy_decoder as j_greedy
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode import timestamps as pts
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder, strip_eot
from robustsq_whisper_torch.models import TSDecoder, WhisperDims

TS_BEGIN, EOT, VOCAB, SOP = 40, 2, 64, 3  # text 0..39 (eot 2), timestamps 40..63
DIMS = dict(
    n_mels=80, n_vocab=VOCAB, n_audio_ctx=16, n_audio_state=128, n_audio_head=2,
    n_audio_layer=1, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Tok:
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


SEQS = [[], [42], [42, 5], [42, 5, 44], [42, 5, 44, 44], [42, 5, 44, 44, 7, 9], [41, 41],
        [40], [43, 8, 43]]


def _state(seq):
    last = seq[-1] if seq else -1
    penult = seq[-2] if len(seq) > 1 else -1
    max_ts = max([t for t in seq if t >= TS_BEGIN], default=TS_BEGIN)
    return last, penult, max_ts


def test_rules_equal_jax_on_random_logits():
    """Every rule state (first token, lone and paired timestamps, text in
    a segment) on random logits at several scales, the last third leaning
    to timestamps (so the timestamp-mass rule fires on some rows and not
    on others): the masked logits equal
    JAX's to 1e-6, which masks the same tokens; the state update too."""
    rng = np.random.default_rng(0)
    rows = SEQS * 3
    scale = np.repeat([1.0, 3.0, 2.0], len(SEQS))[:, None]
    logits = rng.standard_normal((len(rows), VOCAB)) * scale
    logits[2 * len(SEQS):, TS_BEGIN:] += 2.0  # the last third leans to timestamps
    logits = logits.astype(np.float32)
    last, penult, max_ts = (np.array(x, np.int32) for x in zip(*map(_state, rows)))
    want = np.asarray(jts.apply_timestamp_rules(
        jnp.asarray(logits), jnp.asarray(last), jnp.asarray(penult), jnp.asarray(max_ts),
        TS_BEGIN, EOT, max_initial_index=5))
    got = pts.apply_timestamp_rules(
        torch.from_numpy(logits), torch.from_numpy(last), torch.from_numpy(penult),
        torch.from_numpy(max_ts), TS_BEGIN, EOT, max_initial_index=5).numpy()
    np.testing.assert_array_equal(got < -1e29, want < -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # rows in a segment (text and timestamps both allowed by the pair rule):
    # the mass rule masks the text of some and not of others
    text = (np.arange(VOCAB) < TS_BEGIN) & (np.arange(VOCAB) != EOT)
    free = [i for i, r in enumerate(rows) if r and r[-1] < TS_BEGIN]
    forced = (want[free][:, text] < -1e29).all(axis=1)
    assert forced.any() and not forced.all()
    tok = np.where(np.arange(len(rows)) % 2, 7, 45).astype(np.int32)
    j_new = jts.update_timestamp_state(jnp.asarray(tok), jnp.asarray(last), jnp.asarray(max_ts),
                                       TS_BEGIN)
    p_new = pts.update_timestamp_state(torch.from_numpy(tok), torch.from_numpy(last),
                                       torch.from_numpy(max_ts), TS_BEGIN)
    for j, p in zip(j_new, p_new):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("row", [[42, 5, 6, 44, 44, 7, 46], [42, 5, 6, 44, 46, 7, 8],
                                 [5, 42, 43, 43, 9], []])
def test_segments_equal_jax(row):
    assert pts.segments_from_tokens(row, Tok(), TS_BEGIN) == jts.segments_from_tokens(
        row, Tok(), TS_BEGIN)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((3, 12, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((3, 2, 128)).astype(np.float32) * 3
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    variables = jax.jit(jd.init)(
        jax.random.PRNGKey(3), jnp.asarray(memory), jnp.zeros((3, 4), jnp.int32),
        jnp.asarray(prompt))
    td = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4),
                   variables)
    return jd, td, variables, memory, prompt


CFG = dict(max_new_tokens=14, eot=EOT, init_tokens=(1,), with_timestamps=True,
           timestamp_begin=TS_BEGIN, max_initial_timestamp_index=4, quantize_cross_kv=True)


@pytest.mark.parametrize("extra", [{}, dict(min_new_tokens=6)], ids=["plain", "min-new"])
def test_greedy_with_timestamps_equals_jax(setup, extra):
    """Tokens identical, scores within 1e-4, segments identical; each row
    starts with a timestamp in the initial window and its timestamps never
    go back."""
    jd, td, variables, memory, prompt = setup
    cfg = dict(CFG, **extra)
    j_tok, j_sc = (np.asarray(x) for x in j_greedy(jd, variables, JDecodeConfig(**cfg))(
        jnp.asarray(memory), jnp.asarray(prompt)))
    p_tok, p_sc = build_beam_decoder(td, DecodeConfig(**cfg), device="cpu")(
        torch.from_numpy(memory), torch.from_numpy(prompt))
    np.testing.assert_array_equal(p_tok.numpy(), j_tok)
    np.testing.assert_allclose(p_sc.numpy(), j_sc, rtol=1e-4, atol=1e-4)
    rows = strip_eot(p_tok, EOT)
    assert sum(t < TS_BEGIN for r in rows for t in r) > 0  # some text
    for row, j_row in zip(rows, strip_eot(j_tok, EOT)):
        assert TS_BEGIN <= row[0] <= TS_BEGIN + 4, row
        ts = [t for t in row if t >= TS_BEGIN]
        assert ts == sorted(ts), row
        assert pts.segments_from_tokens(row, Tok(), TS_BEGIN) == jts.segments_from_tokens(
            j_row, Tok(), TS_BEGIN)


def test_timestamp_rejections(setup):
    """Beam search and speculative decode refuse timestamps, as JAX's
    decoders do; so does a vocabulary without timestamp tokens."""
    td = setup[1]
    cfg = DecodeConfig(**CFG)
    with pytest.raises(ValueError, match="greedy-only"):
        build_beam_decoder(td, dataclasses.replace(cfg, beam_size=3), device="cpu")
    five = TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, flat_self_cache=False)
    with pytest.raises(ValueError, match="plain-greedy only"):
        build_beam_decoder(five, dataclasses.replace(cfg, speculative_gamma=2, draft_layers=1),
                           device="cpu")
    with pytest.raises(ValueError, match="timestamp tokens"):
        build_beam_decoder(td, dataclasses.replace(cfg, timestamp_begin=VOCAB), device="cpu")

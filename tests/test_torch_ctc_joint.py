"""The port's CTC prefix scorer and joint CTC/attention beam search against
the JAX package's on the CPU.

The prefix functions take the same seeded log-probabilities on both sides
and are also held to the numpy references (exact Graves recursions). The
joint decoder runs over flax-initialised decoder weights
(``convert.load_flax``) and the same numpy memory, speaker prompt, CTC head
and encoder lengths: JAX runs its self-cache kernel in interpret mode, the
port the plain version. Tokens must be identical and the combined scores
agree to 1e-4 (f32 throughout).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode import ctc_prefix as jctc
from robustsq_whisper_tpu.decode.joint import build_joint_beam_decoder as j_joint
from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode import ctc_prefix as pctc
from robustsq_whisper_torch.decode.joint import build_joint_beam_decoder
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder, strip_eot
from robustsq_whisper_torch.models import TSDecoder, WhisperDims

DIMS = dict(
    n_mels=80, n_vocab=40, n_audio_ctx=16, n_audio_state=128, n_audio_head=2,
    n_audio_layer=1, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2,
)
SOP, EOT, PROMPT = 3, 2, 4  # PROMPT: speaker-prompt frames ahead of the audio
BASE = dict(max_new_tokens=6, eot=EOT, init_tokens=(1, 5), beam_size=3, pre_beam=6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_logp(rng, shape):
    x = rng.standard_normal(shape) * 1.5
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def test_prefix_functions_equal_jax_and_numpy():
    """mask_ctc_logp, init_state, score_candidates (three extensions along
    planned sequences, one utterance shorter) and eos_score: equal to JAX's
    to 1e-5 and to the numpy references to 1e-4; the port's numpy
    references are JAX's."""
    rng = np.random.default_rng(1)
    b, t, v = 2, 7, 6
    logp_np = _rand_logp(rng, (b, t, v))
    lens = np.array([7, 5], np.int32)
    j_lp = jctc.mask_ctc_logp(jnp.asarray(logp_np), jnp.asarray(lens))
    p_lp = pctc.mask_ctc_logp(torch.from_numpy(logp_np), torch.from_numpy(lens))
    np.testing.assert_array_equal(p_lp.numpy(), np.asarray(j_lp))
    j_st, p_st = jctc.init_state(j_lp), pctc.init_state(p_lp)
    np.testing.assert_allclose(p_st.numpy(), np.asarray(j_st), rtol=1e-6, atol=1e-5)
    cands = np.array([[1, 2, 3, 5], [1, 3, 4, 5]], np.int64)
    seqs = [[1, 3, 3], [4, 1, 4]]
    j_last, p_last = jnp.asarray([-1, -1]), torch.tensor([-1, -1])
    prefix = [[], []]
    for step in range(3):
        j_psi, j_new = jctc.score_candidates(j_st, j_last, j_lp, jnp.asarray(cands))
        p_psi, p_new = pctc.score_candidates(p_st, p_last, p_lp, torch.from_numpy(cands))
        np.testing.assert_allclose(p_psi.numpy(), np.asarray(j_psi), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), rtol=1e-5, atol=1e-5)
        for row in range(b):
            for ci, c in enumerate(cands[row]):
                want = pctc.ctc_prefix_score_np(logp_np[row, : lens[row]], prefix[row] + [int(c)])
                assert want == jctc.ctc_prefix_score_np(
                    logp_np[row, : lens[row]], prefix[row] + [int(c)])
                np.testing.assert_allclose(float(p_psi[row, ci]), want, rtol=1e-4, atol=1e-4)
        pick = [int(np.flatnonzero(cands[r] == seqs[r][step])[0]) for r in range(b)]
        j_st = jnp.stack([j_new[r, pick[r]] for r in range(b)])
        p_st = torch.stack([p_new[r, pick[r]] for r in range(b)])
        j_last = jnp.asarray([seqs[r][step] for r in range(b)])
        p_last = torch.tensor([seqs[r][step] for r in range(b)])
        for r in range(b):
            prefix[r].append(seqs[r][step])
    p_eos = pctc.eos_score(p_st)
    np.testing.assert_allclose(p_eos.numpy(), np.asarray(jctc.eos_score(j_st)),
                               rtol=1e-5, atol=1e-5)
    for r in range(b):
        want = pctc.ctc_label_prob_np(logp_np[r, : lens[r]], prefix[r])
        assert want == jctc.ctc_label_prob_np(logp_np[r, : lens[r]], prefix[r])
        np.testing.assert_allclose(float(p_eos[r]), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    # scaled memory and prompt keep the random decoder from repeating one token
    memory = rng.standard_normal((2, PROMPT + 12, 128)).astype(np.float32) * 3
    prompt = memory[:, :PROMPT].copy()
    w_ctc = (rng.standard_normal((128, 40)) * 0.2).astype(np.float32)
    b_ctc = (rng.standard_normal((40,)) * 0.5).astype(np.float32)
    jd = JDec(JDims(**DIMS), startofprev_token=SOP)
    variables = jax.jit(jd.init)(
        jax.random.PRNGKey(3), jnp.asarray(memory), jnp.zeros((2, 4), jnp.int32),
        jnp.asarray(prompt),
    )
    td = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP), variables)
    ctc_lo = (torch.from_numpy(w_ctc.T.copy()), torch.from_numpy(b_ctc))
    j_ctc = {"kernel": jnp.asarray(w_ctc), "bias": jnp.asarray(b_ctc)}
    return dict(memory=memory, prompt=prompt, variables=variables, jd=jd, td=td,
                ctc_lo=ctc_lo, j_ctc=j_ctc, mem_lens=np.array([PROMPT + 12, PROMPT + 7], np.int32))


def _both(s, **cfg):
    """(JAX tokens, scores), (port tokens, scores) of the joint decoder."""
    c = dict(BASE, **cfg)
    j_run = j_joint(s["jd"], s["variables"], lambda v, m: m @ v["kernel"] + v["bias"],
                    s["j_ctc"], JDecodeConfig(**c), prompt_frames=PROMPT)
    j_out = j_run(jnp.asarray(s["memory"]), jnp.asarray(s["prompt"]), jnp.asarray(s["mem_lens"]))
    p_run = build_joint_beam_decoder(s["td"], s["ctc_lo"], DecodeConfig(**c),
                                     prompt_frames=PROMPT, device="cpu")
    p_out = p_run(torch.from_numpy(s["memory"]), torch.from_numpy(s["prompt"]),
                  torch.from_numpy(s["mem_lens"]))
    return tuple(np.asarray(x) for x in j_out), tuple(x.numpy() for x in p_out)


@pytest.mark.parametrize("w", [0.3, 0.5])
def test_joint_beam_equals_jax(setup, w):
    """Tokens identical, combined scores within 1e-4; the second utterance
    is shorter (its frames beyond mem_lens masked) and a length penalty
    normalises the final pick."""
    (j_tok, j_sc), (p_tok, p_sc) = _both(setup, ctc_decode_weight=w, length_penalty=1.0)
    assert p_tok.dtype == np.int32 and p_tok.shape == j_tok.shape
    np.testing.assert_array_equal(p_tok, j_tok)
    assert len(set(p_tok.ravel().tolist())) > 2  # not degenerate
    np.testing.assert_allclose(p_sc, j_sc, rtol=1e-4, atol=1e-4)


def test_joint_w0_equals_attention_beam(setup):
    """At ctc_decode_weight 0 with a pre-beam covering the vocabulary the
    joint decoder is the attention beam search, token for token."""
    s = setup
    cfg = dict(BASE, max_new_tokens=5, pre_beam=40)
    p_run = build_joint_beam_decoder(s["td"], s["ctc_lo"],
                                     DecodeConfig(**cfg, ctc_decode_weight=0.0),
                                     prompt_frames=PROMPT, device="cpu")
    att = build_beam_decoder(s["td"], DecodeConfig(**cfg), device="cpu")
    mem, prm = torch.from_numpy(s["memory"]), torch.from_numpy(s["prompt"])
    joint_tok, joint_sc = p_run(mem, prm)
    att_tok, att_sc = att(mem, prm)
    assert strip_eot(joint_tok, EOT) == strip_eot(att_tok, EOT)
    torch.testing.assert_close(joint_sc, att_sc, rtol=1e-4, atol=1e-4)


def test_joint_length_bounds(setup):
    """maxlenratio caps each utterance at floor(ratio * its CTC frames),
    minlenratio masks eot below floor(ratio * frames): the JAX decoder's
    bounds and tokens."""
    (j_tok, _), (p_tok, _) = _both(setup, ctc_decode_weight=0.2, max_new_tokens=8,
                                   maxlenratio=0.5, minlenratio=0.25)
    np.testing.assert_array_equal(p_tok, j_tok)
    rows = strip_eot(p_tok, EOT)
    # CTC frames 12 and 7: maxlen 6 and 3, minlen 3 and 1; the static
    # budget is floor(0.5 * 12) = 6 steps
    assert p_tok.shape == (2, 6)
    assert 3 <= len(rows[0]) <= 6 and 1 <= len(rows[1]) <= 3


def test_joint_refuses_what_jax_refuses(setup):
    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.models import QFormerTSEncoder, TSEncoderConfig

    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        build_joint_beam_decoder(setup["td"], setup["ctc_lo"],
                                 DecodeConfig(**BASE, ctc_decode_weight=1.0), device="cpu")
    enc = QFormerTSEncoder(WhisperDims(**DIMS),
                           TSEncoderConfig(num_query_tokens=PROMPT, num_hidden_layers=1))
    cfg = DecodeConfig(**BASE, ctc_decode_weight=0.3)
    with pytest.raises(ValueError, match="CTC head"):
        build_decode_fns(enc, setup["td"], cfg, device="cpu")
    with pytest.raises(ValueError, match="decode/joint.py"):
        build_beam_decoder(setup["td"], cfg, device="cpu")
    _, run = build_decode_fns(enc, setup["td"], dataclasses.replace(cfg, pre_beam=4),
                              device="cpu", ctc_lo=setup["ctc_lo"])
    tokens, scores = run(torch.from_numpy(setup["memory"]), torch.from_numpy(setup["prompt"]),
                         torch.from_numpy(setup["mem_lens"]))
    assert tokens.shape == (2, BASE["max_new_tokens"]) and torch.isfinite(scores).all()

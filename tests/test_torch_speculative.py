"""Decoding over every self-cache layout, and speculative decode, against
the JAX package's decoders on the CPU.

Same flax-initialised weights (``convert.load_flax``) and the same numpy
encoder memory and speaker prompt go through both sides: JAX runs its
Pallas kernels in interpret mode, the port the kernels' plain versions.
Tokens must be identical and summed log-probs agree to 1e-4 (f32 through
the decoder). Speculative decode must also return JAX's acceptance
counters exactly and the port's own greedy tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.decode.search import build_beam_decoder as j_beam
from robustsq_whisper_tpu.decode.speculative import build_speculative_decoder as j_spec
from robustsq_whisper_tpu.decode.speculative import draft_variables
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder
from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
from robustsq_whisper_torch.models import TSDecoder, WhisperDims

DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=3,
)
SOP, EOT = 3, 2
BASE = dict(max_new_tokens=12, eot=EOT, init_tokens=(1, 4), quantize_cross_kv=True)
LAYOUTS = {
    "flat-int8": dict(self_kv_bits=8),
    "tmin": dict(tmin_self_cache=True),
    "5d": dict(flat_self_cache=False),
    "5d-int8": dict(flat_self_cache=False, self_kv_bits=8),
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    # scaled memory and prompt keep the random decoder from repeating one
    # token, so beams reorder and drafts are sometimes rejected
    memory = rng.standard_normal((2, 40, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3
    init = lambda d, seed: jax.jit(d.init)(
        jax.random.PRNGKey(seed), jnp.asarray(memory), jnp.zeros((2, 4), jnp.int32),
        jnp.asarray(prompt),
    )
    variables = init(JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4), 5)
    # a separate 1-layer draft: the target's first layer, perturbed, so it
    # has weights of its own yet agrees with the target now and then
    keys = iter(jax.random.split(jax.random.PRNGKey(6), 64))
    draft_vars = jax.tree_util.tree_map(
        lambda x: x * (1 + 0.05 * jax.random.normal(next(keys), x.shape)),
        draft_variables(variables, 1),
    )
    return variables, draft_vars, memory, prompt


def _decoders(setup, **kw):
    variables = setup[0]
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw)
    td = load_flax(
        TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw),
        variables,
    )
    return jd, td


def _assert_same(j_out, t_out):
    (j_tok, j_score), (t_tok, t_score) = j_out[:2], t_out[:2]
    t_tok, t_score = t_tok.numpy(), t_score.numpy()
    assert t_tok.shape == (2, BASE["max_new_tokens"]) and t_tok.dtype == np.int32
    np.testing.assert_array_equal(t_tok, np.asarray(j_tok))
    assert len(set(t_tok.ravel().tolist())) > 2  # not degenerate
    np.testing.assert_allclose(t_score, np.asarray(j_score), rtol=1e-4, atol=1e-4)


def _run_both(setup, kw, cfg):
    jd, td = _decoders(setup, **kw)
    _, _, memory, prompt = setup
    j_out = j_beam(jd, setup[0], JDecodeConfig(**cfg))(jnp.asarray(memory), jnp.asarray(prompt))
    run = build_beam_decoder(td, DecodeConfig(**cfg), device="cpu")
    return j_out, run(torch.from_numpy(memory), torch.from_numpy(prompt)), td


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_tokens_identical_per_layout(setup, layout):
    """Greedy over the int8 flat, time-minor and 5-D (dense, int8) caches;
    greedy takes the time-minor cache when asked for, as JAX does."""
    j_out, t_out, td = _run_both(setup, LAYOUTS[layout], dict(BASE, min_new_tokens=3))
    _assert_same(j_out, t_out)
    cache = td.init_cache(2, 20)
    assert td.decoder._cache_layout(cache) == layout.split("-")[0]


@pytest.mark.parametrize(
    "layout,reorder",
    [("5d", "auto"), ("flat-int8", "auto"), ("5d-int8", "auto")],
    ids=["5d-flattened-kernel", "flat-int8", "5d-int8-take"],
)
def test_beam_tokens_identical_per_layout(setup, layout, reorder):
    """Beam 3 over the 5-D dense cache (the cache length padded so the
    flattened reorder's chunks tile; "auto" takes it), the int8 flat cache
    (the in-place reorder of all three leaves) and the 5-D int8 cache
    ("auto" takes index_select: its f32 scales would need a long pad)."""
    cfg = dict(BASE, beam_size=3, beam_reorder=reorder, length_penalty=1.0)
    j_out, t_out, _ = _run_both(setup, LAYOUTS[layout], cfg)
    _assert_same(j_out, t_out)


SPEC_CASES = {  # name: (separate draft, gamma, min_new_tokens)
    "self-g1": (False, 1, 0),
    "self-g4-min-new": (False, 4, 5),
    "separate-g4": (True, 4, 0),
    "separate-g1-min-new": (True, 1, 5),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_speculative_identical_to_jax_and_greedy(setup, case):
    """Self-drafting (1 of 3 layers) and a separate 1-layer draft: tokens,
    scores and the chunks / accepted / emitted counters equal JAX's, and
    the tokens equal the port's own greedy decode."""
    separate, gamma, min_new = SPEC_CASES[case]
    variables, draft_vars, memory, prompt = setup
    cfg = dict(BASE, speculative_gamma=gamma, draft_layers=1, min_new_tokens=min_new)
    jd, td = _decoders(setup, flat_self_cache=False)
    j_out = j_spec(jd, variables, JDecodeConfig(**cfg), return_stats=True,
                   draft_vars=draft_vars if separate else None)(
        jnp.asarray(memory), jnp.asarray(prompt))
    draft = None
    if separate:
        draft = load_flax(TSDecoder(WhisperDims(**dict(DIMS, n_text_layer=1)),
                                    startofprev_token=SOP, cross_kv_bits=4), draft_vars)
    run = build_speculative_decoder(td, DecodeConfig(**cfg), device="cpu",
                                    return_stats=True, draft=draft)
    t_out = run(torch.from_numpy(memory), torch.from_numpy(prompt))
    _assert_same(j_out, t_out)
    for key in ("chunks", "accepted", "emitted"):
        np.testing.assert_array_equal(t_out[2][key].numpy(), np.asarray(j_out[2][key]))
    assert t_out[2]["accepted"].sum() > 0  # some drafts were accepted
    assert (t_out[2]["accepted"] < t_out[2]["chunks"] * gamma).any()  # and some not
    greedy = build_beam_decoder(
        td, dataclasses.replace(DecodeConfig(**cfg), speculative_gamma=0), device="cpu"
    )(torch.from_numpy(memory), torch.from_numpy(prompt))
    assert torch.equal(greedy[0], t_out[0])


def test_speculative_rejects_flat_cache_and_beam(setup):
    _, td = _decoders(setup)  # the flat cache: no ragged writes
    cfg = DecodeConfig(**BASE, speculative_gamma=2, draft_layers=1)
    with pytest.raises(ValueError, match="flat_self_cache=False"):
        build_speculative_decoder(td, cfg, device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        build_beam_decoder(td, dataclasses.replace(cfg, beam_size=3), device="cpu")
    with pytest.raises(ValueError, match="timestamp"):
        build_beam_decoder(td, dataclasses.replace(cfg, with_timestamps=True), device="cpu")


def test_decode_fns_take_a_draft_only_for_speculative_decode(setup):
    """build_decode_fns returns the speculative runner, with its counters,
    when speculative_gamma > 0, and refuses a draft otherwise."""
    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.models import QFormerTSEncoder, TSEncoderConfig

    _, td = _decoders(setup, flat_self_cache=False)
    enc = QFormerTSEncoder(WhisperDims(**DIMS), TSEncoderConfig(num_hidden_layers=1))
    draft = TSDecoder(WhisperDims(**dict(DIMS, n_text_layer=1)), startofprev_token=SOP)
    with pytest.raises(ValueError, match="build both alike"):  # int8 cross, the target int4
        build_decode_fns(enc, td, DecodeConfig(**BASE, speculative_gamma=2, draft_layers=1),
                         device="cpu", draft=draft)
    draft = TSDecoder(WhisperDims(**dict(DIMS, n_text_layer=1)), startofprev_token=SOP,
                      cross_kv_bits=4)
    with pytest.raises(ValueError, match="speculative"):
        build_decode_fns(enc, td, DecodeConfig(**BASE), device="cpu", draft=draft)
    cfg = DecodeConfig(**BASE, speculative_gamma=2, draft_layers=1)
    _, run = build_decode_fns(enc, td, cfg, device="cpu", draft=draft)
    _, _, memory, prompt = setup
    tokens, scores, stats = run(torch.from_numpy(memory), torch.from_numpy(prompt))
    assert tokens.shape == (2, BASE["max_new_tokens"]) and set(stats) == {
        "chunks", "accepted", "emitted"}

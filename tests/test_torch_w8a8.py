"""W8A8 serving (``quantize_weights``, ``--int8_weights``) against the JAX
package, on the CPU.

Numpy inputs from a seed go through the JAX functions (Pallas in interpret
mode) and their counterparts in the port (the kernels' plain versions):

- ``quantize_weight`` / ``quantize_activation`` give identical codes and
  scales, and ``qmatmul_plain`` JAX's ``qmatmul`` within 1e-6 of the
  output's largest magnitude (the f32 epilogue may round otherwise there,
  the int32 sums are exact on both sides);
- ``quantize_step_weights`` / ``quantize_encoder_weights`` of the bridged
  modules equal JAX's, passed through ``convert.flax_qw_to_port``, exactly;
- one decode step with the step weights over every self-cache layout (the
  dense and int8 flat caches, the time-minor one, the 5-D dense and int8
  ones, the deferred beam reorder's ``row_map`` read and the multi-token
  verify) gives JAX's logits within 1e-2 of their std: ten times tighter
  than the JAX package's own W8A8-vs-dense bar (0.1 of the std,
  ``tests/test_decode.py``), while W8A8 moves them further than that from
  the dense step, so the bar tells the two apart. The exception is a code
  flip: where f32 noise of the two packages' attention sums moves an
  activation across a rounding tie, one int8 code differs by one step and
  the rest of the step follows it. The 5-D int8 case meets one on this
  input (layer 1's cross-attention output, an element 8.500011 steps from
  zero: JAX rounds it to 9, the port's value rounds to 8), and its logits
  part by 3.9 % of their std; its bar is 5e-2 of the std, and the test
  checks that a code of the port's step lies that close to a tie
  (ROADMAP C);
- the decoders with ``quantize_weights=True``: the prefill's logits are the
  dense prefill's, exactly; greedy (cross K/V quantized and dense), beam 3
  (eager and deferred) and speculative decode give JAX's tokens, summed
  log-probs to 1e-4, and JAX's acceptance counters. The eager beam meets a
  code flip on this input: tokens equal, one row's score -26.376686
  against JAX's -26.41761 (1.55e-3 relative); its scores are held to
  2e-3 relative;
- the encoder with W8A8 blocks (plain and flash attention): its dense
  output agrees with JAX's to 1e-5, and the W8A8 one is where flips are
  the rule, not the exception (256 rows x 128 channels x 12 matmuls: on
  this input one output in 5 to 8 moves by more than 1e-4 of the std). Its
  mean deviation is held to 2e-3 of the std, a fifth of W8A8's own from
  the dense output (9.7e-3), and its largest to 5e-2, half the JAX
  package's W8A8-vs-dense bar (``tests/test_ts_model.py``).

Every file of the port runs on one torch thread here.
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
from robustsq_whisper_tpu.models import QFormerTSEncoder as JEnc
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.models.ts_decoder import quantize_step_weights as j_step_weights
from robustsq_whisper_tpu.models.ts_encoder import quantize_encoder_weights as j_enc_weights
from robustsq_whisper_tpu.ops import quant as jquant
from robustsq_whisper_torch.convert import flax_qw_to_port, load_flax
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder
from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder, TSEncoderConfig
from robustsq_whisper_torch.models import WhisperDims
from robustsq_whisper_torch.models.ts_decoder import quantize_step_weights
from robustsq_whisper_torch.models.ts_encoder import quantize_encoder_weights
from robustsq_whisper_torch.ops import quant as tquant

torch.set_num_threads(1)
t = torch.from_numpy


# ---- ops ----

@pytest.mark.parametrize("m,k,n,with_bias,out_dtype", [
    (1, 16, 7, True, None), (5, 64, 96, False, None), (20, 1024, 48, True, torch.float32),
    (44, 256, 200, True, None),
])
def test_quant_ops_match_jax(m, k, n, with_bias, out_dtype):
    rng = np.random.default_rng(m + n)
    x = (rng.standard_normal((2, m, k)) * rng.uniform(0.1, 10, (2, m, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    w[1] = 0.0
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None

    j_wq, j_ws = jquant.quantize_weight(jnp.asarray(w.T))  # flax (in, out)
    w_q, w_s = tquant.quantize_weight(t(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(j_wq).T)
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(j_ws))
    for got, ref in zip(tquant.quantize_activation(t(x)), jquant.quantize_activation(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    ref = np.asarray(jquant.qmatmul(
        jnp.asarray(x), j_wq, j_ws, None if bias is None else jnp.asarray(bias),
        out_dtype=None if out_dtype is None else jnp.float32,
    ))
    got = tquant.qmatmul(t(x), w_q, w_s, None if bias is None else t(bias), out_dtype=out_dtype)
    assert got.dtype == torch.float32 and got.shape == (2, m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_qmatmul_rejects_bad_operands():
    w_q, w_s = tquant.quantize_weight(torch.randn(8, 32))
    with pytest.raises(ValueError, match="does not match"):
        tquant.qmatmul(torch.randn(2, 16), w_q, w_s)
    with pytest.raises(TypeError, match="int8"):
        tquant.qmatmul(torch.randn(2, 32), w_q.float(), w_s)
    with pytest.raises(TypeError, match="bias"):
        tquant.qmatmul(torch.randn(2, 32), w_q, w_s, torch.zeros(8, dtype=torch.float64))


# ---- the decoder ----

DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=3,
)
SOP, EOT, B = 3, 2, 2
BASE = dict(max_new_tokens=12, eot=EOT, init_tokens=(1, 4), quantize_cross_kv=True,
            quantize_weights=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    # scaled memory and prompt keep the random decoder from repeating one
    # token, so beams reorder and drafts are sometimes rejected
    memory = rng.standard_normal((B, 40, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((B, 5, 128)).astype(np.float32) * 3
    variables = jax.jit(JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4).init)(
        jax.random.PRNGKey(5), jnp.asarray(memory), jnp.zeros((B, 4), jnp.int32),
        jnp.asarray(prompt),
    )
    keys = iter(jax.random.split(jax.random.PRNGKey(6), 64))
    draft_vars = jax.tree_util.tree_map(
        lambda x: x * (1 + 0.05 * jax.random.normal(next(keys), x.shape)),
        draft_variables(variables, 1),
    )
    return variables, draft_vars, memory, prompt


def _decoders(setup, **kw):
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw)
    td = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw),
                   setup[0]).eval()
    return jd, td


def _assert_same_tree(got, want, path="qw"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for key in want:
            _assert_same_tree(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def test_step_weights_equal_jax(setup):
    """The port's step weights of the bridged decoder equal JAX's through
    ``flax_qw_to_port``: int8 (out, in) per layer, f32 scales and biases
    (none for the key), the per-row int8 tied embedding."""
    _, td = _decoders(setup)
    got = quantize_step_weights(td)
    want = flax_qw_to_port(jax.tree_util.tree_map(np.asarray, j_step_weights(setup[0])))
    assert len(got["layers"]) == DIMS["n_text_layer"]
    w_q, w_s, bias = got["layers"][1]["attn"]["query"]
    assert w_q.dtype == torch.int8 and w_q.shape == (128, 128) and w_s.dtype == torch.float32
    assert bias.dtype == torch.float32 and got["layers"][0]["attn"]["key"][2] is None
    assert got["emb"][0].shape == (64, 128)
    _assert_same_tree(got, want)


def test_encoder_weights_equal_jax(encoder):
    variables, penc = encoder[0], encoder[1][False]
    got = quantize_encoder_weights(penc)
    want = flax_qw_to_port(jax.tree_util.tree_map(np.asarray, j_enc_weights(variables)))
    assert len(got["layers"]) == 2 and set(got["layers"][0]) == {"attn", "fc1", "fc2"}
    _assert_same_tree(got, want)


STEP_CASES = {  # name: (decoder flags, tokens (B, M), pos, prompt positions, step kwargs)
    "flat": (dict(), [[7], [9]], 8, 5, {}),
    "flat-int8": (dict(self_kv_bits=8), [[7], [9]], 8, 5, {}),
    "tmin": (dict(tmin_self_cache=True), [[7], [9]], 8, 5, {}),
    "5d": (dict(flat_self_cache=False), [[7], [9]], 8, 5, {}),
    "5d-int8": (dict(flat_self_cache=False, self_kv_bits=8), [[7], [9]], 8, 5, {}),
    # prefix 1 + 9 + 2 = 11 positions: [0, 8) settled, read through the
    # row map; the window [8, 16) holds logical rows
    "deferred": (dict(), [[7], [9]], 11, 9, dict(row_map=[1, 0], settled=8, defer_window=8)),
    "verify": (dict(flat_self_cache=False), [[7, 5, 6], [9, 9, 4]], [8, 10], 5, {}),
}
FLIPS = {"5d-int8": 5e-2}  # case: bar (of the logits' std) where a code flips


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_with_step_weights_matches_jax(setup, case, monkeypatch):
    """Prefill [sop; prompt; init], then one step with the int8 step
    weights on both sides; the bridged decoder's own weights against
    JAX's (equal, test above)."""
    flags, toks, pos, n_prompt, step_kw = STEP_CASES[case]
    ties = []  # the distance of each W8A8 activation to its nearest rounding tie
    quantize = tquant.quantize_activation

    def recorded(x):
        x_q, scale = quantize(x)
        frac = (x.float() / scale).abs()
        ties.append(float((frac - frac.floor() - 0.5).abs().min()))
        return x_q, scale

    monkeypatch.setattr(tquant, "quantize_activation", recorded)
    rng = np.random.default_rng(9)
    memory = rng.standard_normal((B, 40, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((B, n_prompt, 128)).astype(np.float32) * 3
    variables = setup[0]
    jd, td = _decoders(setup, **flags)
    init = np.tile(np.array([[1, 4]], np.int32), (B, 1))
    toks = np.array(toks, np.int32)
    j_kw = {k: jnp.asarray(v, jnp.int32) if k != "defer_window" else v for k, v in step_kw.items()}
    t_kw = {k: torch.tensor(v, dtype=torch.int32) if k != "defer_window" else v
            for k, v in step_kw.items()}
    jqw = j_step_weights(variables)
    m = lambda meth, *a, **kw: jax.jit(
        lambda v, *x: jd.apply(v, *x, method=meth, **kw))(variables, *a)
    j_cross = m(JDec.cross_kv, jnp.asarray(memory))
    j_cache = jd.apply(variables, B, 24, method=JDec.init_cache)
    _, j_cache = m(JDec.prefill, jnp.asarray(init), jnp.asarray(prompt), j_cache, j_cross)
    j_cross = m(JDec.quantize_cross, j_cross)
    j_args = (jnp.asarray(toks), jnp.asarray(pos, jnp.int32), j_cache, j_cross)
    j_dense, _ = m(JDec.step, *j_args, **j_kw)
    j_step, _ = jax.jit(lambda v, q, *x: jd.apply(v, *x, qw=q, method=JDec.step, **j_kw))(
        variables, jqw, *j_args)
    with torch.inference_mode():
        t_cross = td.cross_kv(t(memory))
        t_cache = td.init_cache(B, 24)
        _, t_cache = td.prefill(t(init).long(), t(prompt), t_cache, t_cross)
        t_step, _ = td.step(t(toks).long(), torch.tensor(pos, dtype=torch.int32),
                            t_cache, td.quantize_cross(t_cross), qw=quantize_step_weights(td),
                            **t_kw)
    ref, dense = np.asarray(j_step), np.asarray(j_dense)
    assert tuple(t_step.shape) == ref.shape
    np.testing.assert_allclose(t_step.numpy(), ref, rtol=0, atol=FLIPS.get(case, 1e-2) * ref.std())
    assert np.abs(ref - dense).max() > 5e-2 * ref.std()  # the step weights moved the logits
    if case in FLIPS:  # a code lay within f32 noise of a tie
        assert min(ties) < 2e-5


def _run_both(setup, kw, cfg):
    jd, td = _decoders(setup, **kw)
    _, _, memory, prompt = setup
    j_out = j_beam(jd, setup[0], JDecodeConfig(**cfg))(jnp.asarray(memory), jnp.asarray(prompt))
    t_out = build_beam_decoder(td, DecodeConfig(**cfg), device="cpu")(t(memory), t(prompt))
    return j_out, t_out, td


def _assert_same(j_out, t_out, score_rtol=1e-4):
    (j_tok, j_score), (t_tok, t_score) = j_out[:2], t_out[:2]
    t_tok, t_score = t_tok.numpy(), t_score.numpy()
    assert t_tok.shape == (B, BASE["max_new_tokens"]) and t_tok.dtype == np.int32
    np.testing.assert_array_equal(t_tok, np.asarray(j_tok))
    assert len(set(t_tok.ravel().tolist())) > 2  # not degenerate
    np.testing.assert_allclose(t_score, np.asarray(j_score), rtol=score_rtol, atol=1e-4)


@pytest.mark.parametrize("beam", [1, 3])
def test_prefill_stays_dense(setup, beam):
    """With one new token the decoders run the prefill alone: with
    ``quantize_weights`` its tokens and scores are the dense decoder's,
    bit for bit."""
    _, td = _decoders(setup)
    _, _, memory, prompt = setup
    outs = [
        build_beam_decoder(td, DecodeConfig(**dict(BASE, max_new_tokens=1, beam_size=beam,
                                                   quantize_weights=q)), device="cpu")(
            t(memory), t(prompt))
        for q in (False, True)
    ]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantize_cross", [True, False], ids=["cross-int4", "cross-dense"])
def test_greedy_tokens_equal_jax(setup, quantize_cross):
    cfg = dict(BASE, quantize_cross_kv=quantize_cross, min_new_tokens=3)
    j_out, t_out, _ = _run_both(setup, {}, cfg)
    _assert_same(j_out, t_out)


@pytest.mark.parametrize("defer,score_rtol", [(0, 2e-3), (8, 1e-4)], ids=["eager", "deferred"])
def test_beam_tokens_equal_jax(setup, defer, score_rtol):
    """The eager beam's scores take the code-flip bar (module docstring)."""
    cfg = dict(BASE, beam_size=3, length_penalty=1.0, defer_reorder=defer)
    j_out, t_out, _ = _run_both(setup, {}, cfg)
    _assert_same(j_out, t_out, score_rtol)


@pytest.mark.parametrize("separate", [False, True], ids=["self-draft", "separate-draft"])
def test_speculative_equals_jax(setup, separate):
    """Tokens, scores and the chunks / accepted / emitted counters equal
    JAX's; the self-draft takes the target's first layer of the step
    weights and a separate draft quantizes its own."""
    variables, draft_vars, memory, prompt = setup
    cfg = dict(BASE, speculative_gamma=4, draft_layers=1)
    jd, td = _decoders(setup, flat_self_cache=False)
    j_out = j_spec(jd, variables, JDecodeConfig(**cfg), return_stats=True,
                   draft_vars=draft_vars if separate else None)(
        jnp.asarray(memory), jnp.asarray(prompt))
    draft = None
    if separate:
        draft = load_flax(TSDecoder(WhisperDims(**dict(DIMS, n_text_layer=1)),
                                    startofprev_token=SOP, cross_kv_bits=4), draft_vars)
    t_out = build_speculative_decoder(td, DecodeConfig(**cfg), device="cpu",
                                      return_stats=True, draft=draft)(t(memory), t(prompt))
    _assert_same(j_out, t_out)
    for key in ("chunks", "accepted", "emitted"):
        np.testing.assert_array_equal(t_out[2][key].numpy(), np.asarray(j_out[2][key]))
    assert t_out[2]["accepted"].sum() > 0
    greedy = build_beam_decoder(
        td, dataclasses.replace(DecodeConfig(**cfg), speculative_gamma=0), device="cpu"
    )(t(memory), t(prompt))
    assert torch.equal(greedy[0], t_out[0])


# ---- the encoder ----

ENC_DIMS = dict(DIMS, n_audio_ctx=256, n_audio_layer=2)
ENC_TS = dict(num_query_tokens=16, num_hidden_layers=1, qformer_hidden_size=64,
              qformer_heads=2, qformer_intermediate_size=96)


@pytest.fixture(scope="module")
def encoder():
    """JAX encoder variables (2 blocks, 240 speech frames + 16 prompt
    tokens), the inputs, and the bridged port encoders without and with
    ``use_flash_attention`` (the same weights)."""
    rng = np.random.default_rng(3)
    inputs = (rng.standard_normal((2, 80, 480)).astype(np.float32), np.array([480, 400]),
              rng.standard_normal((2, 80, 40)).astype(np.float32), np.array([40, 30]))
    variables = jax.jit(JEnc(JDims(**ENC_DIMS), JTS(**ENC_TS)).init)(
        jax.random.PRNGKey(4), *map(jnp.asarray, inputs))
    ports = {
        flash: load_flax(QFormerTSEncoder(WhisperDims(**ENC_DIMS), TSEncoderConfig(
            **ENC_TS, use_flash_attention=flash)), variables).eval()
        for flash in (False, True)
    }
    return variables, ports, inputs


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_encoder_with_block_weights_matches_jax(encoder, flash):
    """The Qformer encoder with W8A8 Whisper blocks: with
    ``use_flash_attention`` the blocks' attention (``attend`` with ``qw``)
    takes the row-major flash route (T = 256) on both sides. The bars are
    the module docstring's; the prompt runs before the blocks and agrees to
    f32 noise."""
    variables, ports, inputs = encoder
    enc = JEnc(JDims(**ENC_DIMS), JTS(**ENC_TS, use_flash_attention=flash))
    j_in = tuple(map(jnp.asarray, inputs))
    j_out = jax.jit(lambda v, q, *x: enc.apply(v, *x, qw=q))(
        variables, j_enc_weights(variables), *j_in)
    j_dense = np.asarray(jax.jit(enc.apply)(variables, *j_in)[0])
    penc = ports[flash]
    with torch.inference_mode():
        got = penc(*map(t, inputs), qw=quantize_encoder_weights(penc))
        dense = penc(*map(t, inputs))[0]
    ref, std = np.asarray(j_out[0]), np.asarray(j_out[0]).std()
    assert got[0].shape == (2, 256, 128)
    np.testing.assert_allclose(dense.numpy(), j_dense, rtol=0, atol=1e-5)
    diff = np.abs(got[0].numpy() - ref)
    assert diff.mean() < 2e-3 * std and diff.max() < 5e-2 * std, (diff.mean(), diff.max())
    assert np.abs(ref - j_dense).mean() > 5e-3 * std  # W8A8 moved the output
    np.testing.assert_allclose(got[2].numpy(), np.asarray(j_out[2]), rtol=1e-5, atol=1e-5)

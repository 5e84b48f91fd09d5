"""Multi-GPU serving of the port against the JAX package's, on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices (``conftest.py``):
its ``build_sharded_decoder`` over ``make_mesh(n, 1)`` and its
``build_tp_decoder`` over ``make_mesh(2, 2)``. The port's side runs in
gloo worker processes (``tests/_torch_dist.py``), one per rank with one
torch thread, each decoding its rows; the whole batch's outputs come back
to every rank. Tokens must be identical, scores agree to 1e-4 (f32 through
the decoder, JAX's TP sums in another order) and the speculative counters
exactly. The placement rules are held to JAX's ``param_pspec`` /
``_fsdp_spec`` by parameter name through ``convert.py``'s mapping.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.decode.sharded import build_sharded_decoder as j_dp
from robustsq_whisper_tpu.decode.sharded import build_tp_decoder as j_tp
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.parallel import mesh as jmesh
from robustsq_whisper_torch.convert import flax_to_state_dict
from robustsq_whisper_torch.parallel import mesh as tmesh

from ._torch_dist import launch

DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=3,
)
SOP, EOT, B = 3, 2, 4
BASE = dict(max_new_tokens=12, eot=EOT, init_tokens=(1, 4), quantize_cross_kv=True)
DENSE = dict(BASE, quantize_cross_kv=False)
FIVE_D = dict(flat_self_cache=False)
CASES = {  # name: (decoder kwargs, DecodeConfig kwargs)
    "greedy": ({}, dict(BASE, min_new_tokens=3)),
    "beam3": ({}, dict(BASE, beam_size=3, length_penalty=1.0)),
    "speculative": (FIVE_D, dict(BASE, speculative_gamma=3, draft_layers=1)),
    "tp-greedy": (FIVE_D, dict(DENSE, min_new_tokens=3)),
    "tp-beam3": (FIVE_D, dict(DENSE, beam_size=3, length_penalty=1.0)),
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    # scaled memory and prompt keep the random decoder from repeating one
    # token, so beams reorder and drafts are sometimes rejected
    memory = rng.standard_normal((B, 40, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((B, 5, 128)).astype(np.float32) * 3
    dec = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    variables = jax.jit(dec.init)(
        jax.random.PRNGKey(5), jnp.asarray(memory), jnp.zeros((B, 4), jnp.int32),
        jnp.asarray(prompt),
    )
    return variables, memory, prompt


def _jax_outputs(setup, name, mesh):
    variables, memory, prompt = setup
    dec_kw, cfg_kw = CASES[name]
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **dec_kw)
    cfg = JDecodeConfig(**cfg_kw)
    if name.startswith("tp-"):
        run = j_tp(jd, variables, cfg, mesh)
    else:
        run = j_dp(jd, variables, cfg, mesh, return_stats=cfg.speculative_gamma > 0)
    return jax.device_get(run(jnp.asarray(memory), jnp.asarray(prompt)))


def _port_outputs(setup, tmp_path, world, cases, embedding=None):
    variables, memory, prompt = setup
    torch.save({
        "dims": DIMS, "sop": SOP, "cross_kv_bits": 4, "memory": memory, "prompt": prompt,
        "decoder": flax_to_state_dict(variables),
        "cases": [(name, CASES[name][0], CASES[name][1], shape) for name, shape in cases],
        **({"embedding": embedding} if embedding else {}),
    }, tmp_path / "inputs.pt")
    launch("decode", world, str(tmp_path))
    return [torch.load(tmp_path / f"out-{r}.pt", weights_only=False) for r in range(world)]


def _assert_same(j_out, t_out, name):
    np.testing.assert_array_equal(t_out[0], np.asarray(j_out[0]), err_msg=name)
    assert len(set(t_out[0].ravel().tolist())) > 2  # not degenerate
    np.testing.assert_allclose(t_out[1], np.asarray(j_out[1]), rtol=1e-4, atol=1e-4,
                               err_msg=name)
    if len(j_out) == 3:  # speculative counters, per row
        for k in ("chunks", "accepted", "emitted"):
            np.testing.assert_array_equal(t_out[2][k], np.asarray(j_out[2][k]), err_msg=k)


EMB_DIMS = dict(
    n_mels=80, n_vocab=300, n_audio_ctx=32, n_audio_state=32, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=64, n_text_state=32, n_text_head=2, n_text_layer=1,
)
EMB_TS = dict(enroll_type="embedding", enroll_size=16, adapter_method="cat")
EMB_CFG = dict(max_new_tokens=8, eot=258, init_tokens=(257,), quantize_cross_kv=True)


def _embedding_case(world):
    """The embedding-enrollment encoder and a prompt-free decoder (JAX's
    seeded init, bridged): JAX's data-parallel ``build_decode_fns`` over
    ``world`` devices, and the port's inputs."""
    from robustsq_whisper_tpu.decode.pipeline import build_decode_fns as j_fns
    from robustsq_whisper_tpu.models import SpkAdapterTSEncoder as JEnc
    from robustsq_whisper_tpu.models import TSEncoderConfig as JTS

    rng = np.random.default_rng(3)
    mel = rng.standard_normal((B, 80, 64)).astype(np.float32)
    lens = np.array([64, 41, 60, 52], np.int32)
    emb = rng.standard_normal((B, 16)).astype(np.float32)
    jenc = JEnc.from_config(JDims(**EMB_DIMS), JTS(**EMB_TS))
    enc_vars = jenc.init(jax.random.PRNGKey(0), *map(jnp.asarray, (mel, lens, emb)))
    jdec = JDec(JDims(**EMB_DIMS), use_spk_prompt=False)
    memory = jnp.zeros((B, 32, 32), jnp.float32)
    dec_vars = jdec.init(jax.random.PRNGKey(1), memory, jnp.zeros((B, 4), jnp.int32),
                         jnp.zeros((B, 0, 32), jnp.float32))
    encode, run = j_fns(jenc, enc_vars, jdec, dec_vars, JDecodeConfig(**EMB_CFG),
                        jmesh.make_mesh(world, 1), batch_size=B)
    ref = jax.device_get(run(*encode(enc_vars, *map(jnp.asarray, (mel, lens, emb))))[:2])
    port = dict(dims=EMB_DIMS, ts=EMB_TS, cfg=EMB_CFG, inputs=(mel, lens, emb),
                encoder=flax_to_state_dict(enc_vars), decoder=flax_to_state_dict(dec_vars))
    return ref, port


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_decode_equals_jax(setup, tmp_path, world):
    """Greedy, beam 3 and speculative (with its counters) at ``world``
    data ranks equal JAX's sharded decoder over ``world`` devices; at 2
    ranks so does the embedding encoder's decode through
    ``build_decode_fns``, at 4 ranks the tensor-parallel decoder on a 2 x 2
    mesh JAX's ``build_tp_decoder``. Every rank returns the whole batch."""
    dp = ["greedy", "beam3", "speculative"]
    cases = [(n, (world, 1)) for n in dp]
    if world == 4:
        cases += [("tp-greedy", (2, 2)), ("tp-beam3", (2, 2))]
    emb_ref, emb_in = _embedding_case(world) if world == 2 else (None, None)
    outs = _port_outputs(setup, tmp_path, world, cases, emb_in)
    for name, (n_data, n_model) in cases:
        j_out = _jax_outputs(setup, name, jmesh.make_mesh(n_data, n_model))
        for r in range(world):
            _assert_same(j_out, outs[r][name], f"{name} rank {r}")
    if emb_ref is not None:
        for r in range(world):
            tokens, scores = outs[r]["embedding"]
            np.testing.assert_array_equal(tokens, np.asarray(emb_ref[0]))
            np.testing.assert_allclose(scores, np.asarray(emb_ref[1]), rtol=1e-4, atol=1e-4)


# ---- placement rules ----


def _jax_specs(variables, n_data, n_model, fsdp):
    """JAX's spec of every leaf, by the port's parameter name: the flax
    path mapped as ``convert.flax_to_state_dict`` maps it (a zero proxy of
    the leaf's rank goes through it), kernels' dimensions reversed,
    layer-stacked leaves split per layer (their layer axis is never
    sharded)."""
    mesh = jmesh.make_mesh(n_data, n_model)
    params = variables["params"]
    shardings = jmesh.params_shardings(mesh, params, fsdp=fsdp, fsdp_min_elems=0)
    flat = jax.tree_util.tree_flatten_with_path(shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
    specs = {}
    for kp, sh in flat:
        path = [str(getattr(k, "key", k)) for k in kp]
        leaf = params
        for p in path:
            leaf = leaf[p]
        spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        stacked = "block" in path
        proxy = np.zeros([leaf.shape[0] if stacked else 1] + [1] * (leaf.ndim - 1))
        if stacked:
            spec = spec[1:]
        if path[-1] == "kernel":
            spec = spec[::-1]
        tree = proxy
        for p in reversed(path):
            tree = {p: tree}
        for name in flax_to_state_dict({"params": tree}):
            specs[name] = tuple(spec)
    return specs


@pytest.fixture(scope="module")
def train_models():
    from robustsq_whisper_tpu.models import TSASRModel as JModel
    from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
    from robustsq_whisper_tpu.models import TSModelConfig as JCfg
    from robustsq_whisper_torch.convert import load_flax
    from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig
    from robustsq_whisper_torch.models import WhisperDims

    from .test_torch_train import CFG, DIMS as TDIMS, TS, _batch, _jbatch

    jmodel = JModel(JDims(**TDIMS), JTS(**TS), JCfg(**CFG))
    tiny = _jbatch(_batch())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jmodel.init(k, tiny, k, 0, train=False))(key)
    model = TSASRModel(WhisperDims(**TDIMS), TSEncoderConfig(**TS), TSModelConfig(**CFG))
    return variables, load_flax(model, variables)


@pytest.mark.parametrize("n_data,n_model,fsdp", [(1, 2, False), (4, 2, False), (4, 1, True),
                                                 (2, 2, True), (8, 1, True)])
def test_placement_rules_equal_jax(train_models, n_data, n_model, fsdp):
    """Every parameter of a tiny TSASRModel gets JAX's spec: the TP rules,
    the divisibility guard and the FSDP rule (largest free dimension, the
    first of equals in flax order, composed with the TP split), with the
    size threshold at 0 as in JAX's own FSDP test."""
    variables, model = train_models
    want = _jax_specs(variables, n_data, n_model, fsdp)
    got = tmesh.placements(model, n_data, n_model, fsdp=fsdp, fsdp_min_elems=0)
    assert set(got) == set(want)
    for name in sorted(got):
        assert got[name] == want[name], (name, got[name], want[name])
    assert any(tmesh.MODEL_AXIS in s for s in got.values()) == (n_model > 1)
    assert any(tmesh.DATA_AXIS in s for s in got.values()) == fsdp


def test_fsdp_threshold_and_vocab_guard(train_models):
    """Tensors below ``fsdp_min_elems`` stay whole; a vocabulary that the
    model axis does not divide (Whisper's 51865) keeps the embedding whole,
    as JAX's guard does."""
    _, model = train_models
    specs = tmesh.placements(model, 4, 1, fsdp=True, fsdp_min_elems=2**13)
    for name, p in model.named_parameters():
        assert (tmesh.DATA_AXIS in specs[name]) <= (p.numel() >= 2**13), name
    assert tmesh.param_pspec("decoder.decoder.token_embedding.weight", 2) == ("model", None)
    whisper = torch.nn.Module()
    whisper.token_embedding = torch.nn.Embedding(51865, 8)
    assert tmesh.placements(whisper, 1, 2)["token_embedding.weight"] == (None, None)
    assert tmesh.placements(whisper, 1, 5)["token_embedding.weight"] == ("model", None)


def test_shard_seq_is_an_identity_where_jax_is():
    """No mesh, a model group of one rank, or a ragged length: the
    residual stream stays whole (JAX's ``shard_seq`` returns x)."""
    x = torch.randn(4, 10, 8)
    assert tmesh.shard_seq(x, None) is x
    assert not tmesh.sp_applies(None, 16)
    assert tmesh.local_rows(x, None) is x

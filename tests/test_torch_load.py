"""The port's pretrained-Whisper loader (``models/whisper/load.py``) and
``cli.train.build_model(pretrained=...)`` against the JAX package's, on a
tiny OpenAI-format ``.pt`` written by the JAX package's own test helper and
on a synthetic HuggingFace-named state dict. Every comparison is exact:
the maps move f32 values and the appended vocabulary rows come from the
same numpy generator."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from robustsq_whisper_tpu.models.whisper import WhisperDims as JDims
from robustsq_whisper_tpu.models.whisper import load as jload
from robustsq_whisper_torch.convert import flax_to_state_dict
from robustsq_whisper_torch.models.whisper import load as pload

from tests.test_openai_checkpoint import _make_openai_pt

DEV = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "conf/tswhisper/train_tsasr_whisper_dev_smoke.yaml")
DIMS = JDims(
    n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=32, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=24, n_text_state=32, n_text_head=2, n_text_layer=2,
)


def _flat(tree):
    return flax_to_state_dict({"params": tree})


def _assert_same(port, jax_sd):
    assert port.keys() == jax_sd.keys(), sorted(port.keys() ^ jax_sd.keys())
    for k, v in port.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, jax_sd[k]), k


def test_openai_checkpoint_equals_jax(tmp_path):
    path = str(tmp_path / "tiny.pt")
    _make_openai_pt(path, DIMS)
    dims, enc, dec = pload.load_openai_checkpoint(path)
    jdims, jenc, jdec = jload.load_openai_checkpoint(path)
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    _assert_same(enc, _flat(jenc))
    _assert_same(dec, _flat(jdec))
    assert "positional_embedding" not in enc  # the encoder's sinusoids are computed


@pytest.mark.parametrize("expand", [True, False])
def test_adapt_vocab_equals_jax(tmp_path, expand):
    path = str(tmp_path / "tiny.pt")
    _make_openai_pt(path, DIMS)
    _, _, dec = pload.load_openai_checkpoint(path)
    _, _, jdec = jload.load_openai_checkpoint(path)
    got = pload.adapt_vocab(dec, 80, load_origin_token_embedding=expand, seed=3)
    want = jload.adapt_vocab(jdec, 80, load_origin_token_embedding=expand, seed=3)
    _assert_same(got, _flat(want))
    assert got["token_embedding.weight"].shape == (80, 32)
    if expand:
        assert torch.equal(got["token_embedding.weight"][:64], dec["token_embedding.weight"])
    assert pload.adapt_vocab(dec, 64) is dec
    with pytest.raises(ValueError, match="exceed"):
        pload.adapt_vocab(dec, 60)


def _hf_state_dict(dims, part, prefix, seed=0):
    """HF ``WhisperModel`` tensors of the encoder or the decoder, named
    under ``prefix`` ("encoder." / "decoder." in a whole model's dict, ""
    in the part's own)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def w(name, *shape):
        sd[prefix + name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def layer(p, n, cross):
        for a in ("self_attn", "encoder_attn") if cross else ("self_attn",):
            for m in ("q_proj", "v_proj", "out_proj"):
                w(f"{p}.{a}.{m}.weight", n, n)
                w(f"{p}.{a}.{m}.bias", n)
            w(f"{p}.{a}.k_proj.weight", n, n)
            w(f"{p}.{a}_layer_norm.weight", n)
            w(f"{p}.{a}_layer_norm.bias", n)
        w(f"{p}.fc1.weight", 4 * n, n)
        w(f"{p}.fc1.bias", 4 * n)
        w(f"{p}.fc2.weight", n, 4 * n)
        w(f"{p}.fc2.bias", n)
        w(f"{p}.final_layer_norm.weight", n)
        w(f"{p}.final_layer_norm.bias", n)

    if part == "encoder":
        d = dims.n_audio_state
        for name, shape in (("conv1.weight", (d, dims.n_mels, 3)), ("conv1.bias", (d,)),
                            ("conv2.weight", (d, d, 3)), ("conv2.bias", (d,)),
                            ("layer_norm.weight", (d,)), ("layer_norm.bias", (d,))):
            w(name, *shape)
        for i in range(dims.n_audio_layer):
            layer(f"layers.{i}", d, cross=False)
    else:
        td = dims.n_text_state
        w("embed_tokens.weight", dims.n_vocab, td)
        w("embed_positions.weight", dims.n_text_ctx, td)
        w("layer_norm.weight", td)
        w("layer_norm.bias", td)
        for i in range(dims.n_text_layer):
            layer(f"layers.{i}", td, cross=True)
    return sd


@pytest.mark.parametrize("whole", [True, False], ids=["whole-model", "per-part"])
def test_hf_maps_equal_jax(whole):
    """A whole model's state dict (``encoder.`` / ``decoder.`` names) and
    each part's own."""
    enc_sd = _hf_state_dict(DIMS, "encoder", "encoder." if whole else "", seed=1)
    dec_sd = _hf_state_dict(DIMS, "decoder", "decoder." if whole else "", seed=2)
    if whole:
        enc_sd = dec_sd = {**enc_sd, **dec_sd}
    enc = pload.encoder_state_from_hf(enc_sd, DIMS.n_audio_layer)
    dec = pload.decoder_state_from_hf(dec_sd, DIMS.n_text_layer)
    _assert_same(enc, _flat(jload.encoder_params_from_hf(enc_sd, DIMS.n_audio_layer)))
    _assert_same(dec, _flat(jload.decoder_params_from_hf(dec_sd, DIMS.n_text_layer)))
    assert len(enc) == 6 + 15 * DIMS.n_audio_layer and len(dec) == 4 + 24 * DIMS.n_text_layer


def test_build_model_pretrained_equals_jax(tmp_path):
    """``build_model(pretrained=...)`` of the dev smoke config against the
    JAX ``build_model_and_variables``: the Whisper encoder and decoder are
    the file's (the token table adapted from 280 to the config's 300 rows,
    the appended rows the JAX package's), the rest the seeded init."""
    from robustsq_whisper_tpu.cli import train as jtrain
    from robustsq_whisper_tpu.utils.config import load_experiment as jload_exp
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.utils.config import load_experiment

    exp, jexp = load_experiment(DEV), jload_exp(DEV)
    dims = exp.resolved_dims()
    jdims = JDims(**{**dataclasses.asdict(jexp.resolved_dims()), "n_vocab": 280})
    path = str(tmp_path / "dev.pt")
    _make_openai_pt(path, jdims, seed=5)

    rng = np.random.default_rng(0)
    b, n, e = 2, int(exp.speech_seconds * 16000), int(exp.enroll_seconds * 16000)
    batch = {
        "speech": rng.standard_normal((b, n)).astype(np.float32) * 0.1,
        "speech_lens": np.full((b,), n, np.int32),
        "enroll": rng.standard_normal((b, e)).astype(np.float32) * 0.1,
        "enroll_lens": np.full((b,), e, np.int32),
        "text": np.full((b, 8), 5, np.int32), "text_lens": np.full((b,), 8, np.int32),
        "neg_logits": np.ones((b, b), np.float32), "spk_labels": np.zeros((b,), np.int32),
    }
    _, variables = jtrain.build_model_and_variables(jexp, jax.random.PRNGKey(0), path, batch)
    jsd = flax_to_state_dict({"params": variables["params"]})
    model = build_model(exp, seed=0, device="cpu", pretrained=path)
    sd = model.state_dict()
    whisper = [k for k in sd if k.startswith(("encoder.encoder.", "decoder.decoder."))
               and k != "encoder.encoder.positional_embedding"]
    assert len(whisper) == len(pload.load_openai_checkpoint(path)[1]) + len(
        pload.load_openai_checkpoint(path)[2])
    for k in whisper:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], jsd[k]), k
    assert sd["decoder.decoder.token_embedding.weight"].shape == (300, dims.n_text_state)
    # everything else is the seeded init, not the file's
    seeded = build_model(exp, seed=0, device="cpu")
    for k, v in seeded.state_dict().items():
        if k not in whisper:
            assert torch.equal(sd[k], v), k


def test_build_model_pretrained_checks_names_and_shapes(tmp_path):
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.utils.config import load_experiment

    exp = load_experiment(DEV)
    path = str(tmp_path / "small.pt")
    _make_openai_pt(path, DIMS)  # 32 wide: the dev model is 64 wide
    with pytest.raises(ValueError, match="conv1.weight"):
        build_model(exp, device="cpu", pretrained=path)


def test_build_model_pretrained_bf16_keeps_norms_exact(tmp_path):
    """In bf16 compute (``set_compute_dtype``) the Whisper weights are the
    file's cast to bf16, and the layer norms keep the file's f32 values
    (they were once rounded through bf16 on the way)."""
    import dataclasses as dc

    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.utils.config import load_experiment

    exp = dc.replace(load_experiment(DEV), compute_dtype="bfloat16")
    dims = exp.resolved_dims()
    path = str(tmp_path / "dev.pt")
    _make_openai_pt(path, JDims(**{**dataclasses.asdict(dims), "n_vocab": 300}), seed=6)
    _, enc, dec = pload.load_openai_checkpoint(path)
    sd = build_model(exp, seed=0, device="cpu", pretrained=path).state_dict()
    norms = 0
    for prefix, part in (("encoder.encoder.", enc), ("decoder.decoder.", dec)):
        for k, v in part.items():
            got = sd[prefix + k]
            is_norm = "_ln." in k or k.startswith(("ln.", "ln_post."))
            assert got.dtype == (torch.float32 if is_norm else torch.bfloat16), k
            assert torch.equal(got, v.to(got.dtype)), k
            norms += is_norm and not torch.equal(v, v.bfloat16().float())
    assert norms > 0  # values that bf16 would round

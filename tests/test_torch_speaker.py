"""The recipe's stage 103 in the port against the JAX package, on the CPU:
the Kaldi fbank, the ONNX initializer reader, ``SpeakerResNet34`` through
the flax bridge (``convert.flax_speaker_to_state_dict``) and through an
ONNX file, and ``cli.datapre spk-embed``. Everything is f32; each tolerance
is stated where it is used."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.audio import fbank as jfbank
from robustsq_whisper_tpu.models import speaker_resnet as jspk
from robustsq_whisper_tpu.utils import onnx_pb as jonnx
from robustsq_whisper_torch.audio import fbank as pfbank
from robustsq_whisper_torch.convert import flax_speaker_to_state_dict
from robustsq_whisper_torch.models import speaker_resnet as pspk
from robustsq_whisper_torch.utils import onnx_pb as ponnx

from tests.test_onnx_import import _randomized_oracle, encode_onnx

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(seed, b=2, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = np.stack([0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) for i in range(b)])
    return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)


def test_mel_banks_equal_jax():
    np.testing.assert_array_equal(pfbank.kaldi_mel_banks(), jfbank.kaldi_mel_banks(80))
    np.testing.assert_array_equal(pfbank._dft_bank(), jfbank._dft_bank())


def _fbank_f64(audio, lens):
    """The fbank in float64 (the f32 evaluations' common reference)."""
    x = torch.from_numpy(audio).double() * 32768.0
    fr = x.unfold(1, 400, 160)
    fr = fr - fr.mean(-1, keepdim=True)
    fr = fr - 0.97 * torch.cat([fr[..., :1], fr[..., :-1]], -1)
    fr = fr * torch.from_numpy(pfbank._hamming(400))
    proj = fr @ torch.from_numpy(pfbank._dft_bank().astype(np.float64)).t()
    power = proj[..., :257] ** 2 + proj[..., 257:] ** 2
    mel = power @ torch.from_numpy(pfbank.kaldi_mel_banks().astype(np.float64)).t()
    f = torch.log(torch.clamp(mel, min=pfbank.EPS))
    fl = torch.from_numpy(1 + (lens - 400) // 160)
    mask = (torch.arange(f.shape[1])[None] < fl[:, None])[..., None]
    mean = torch.where(mask, f, 0.0).sum(1, keepdim=True) / fl[:, None, None]
    return torch.where(mask, f - mean, 0.0).numpy()


@pytest.mark.parametrize("short", [SR, 9000, 400], ids=["full", "ragged", "one_frame"])
def test_kaldi_fbank_equals_jax(short):
    """Log-mel energies of 2^15-scaled audio (values up to ~20), CMN over
    each row's valid frames (the second row ``short`` samples long). Both
    packages sum the DFT in f32, each in its own order: on this input each
    lies within 1.5e-4 of the float64 evaluation (JAX's 1.1e-4 off it, the
    port's 1.4e-4, measured), so the two are held to each other at 2.5e-4
    absolute and the port to the f64 values at 1.5e-4. Frames past a row's
    length are 0; the frame lengths are exact."""
    audio = _audio(0)
    lens = np.array([SR, short], np.int32)
    want, wl = jfbank.kaldi_fbank(jnp.asarray(audio), jnp.asarray(lens))
    got, gl = pfbank.kaldi_fbank(torch.from_numpy(audio), torch.from_numpy(lens))
    assert got.shape == (2, 98, 80)
    np.testing.assert_allclose(got.numpy(), _fbank_f64(audio, lens), rtol=0, atol=1.5e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2.5e-4)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert int(gl[1]) == 1 + (short - 400) // 160
    assert not got[1, int(gl[1]):].any()


def test_onnx_reader_equals_jax():
    """The port's protobuf reader and JAX's on the same bytes: raw and
    packed dims, floats, int64 and a wrapper prefix."""
    rng = np.random.default_rng(0)
    state = {"module.a.weight": rng.standard_normal((3, 2, 3, 3)).astype(np.float32),
             "module.b.running_mean": rng.standard_normal(7).astype(np.float32),
             "module.c.num_batches_tracked": np.asarray([42], np.int64)}
    for packed in (False, True):
        data = encode_onnx(state, packed_dims=packed)
        got, want = ponnx.read_onnx_initializers(data), jonnx.read_onnx_initializers(data)
        assert got.keys() == want.keys() == state.keys()
        for k in state:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        ponnx.read_onnx_initializers(b"\x08\x01")


def _flax_variables(model, feats, flens, seed):
    """flax init, then every parameter and batch statistic drawn anew
    (running means around 0, variances in [0.5, 1.5]), so the bridge moves
    values that a layout slip would scramble."""
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), feats, flens)
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray((1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray((0.1 * rng.standard_normal(shape)).astype(np.float32))
        fan_in = int(np.prod(shape[:-1]))
        return jnp.asarray((rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, dict(variables))


@pytest.mark.parametrize("stages,base,embed", [((1, 1, 1, 1), 4, 8), ((3, 4, 6, 3), 32, 256)],
                         ids=["tiny", "resnet34"])
def test_resnet_equals_jax_through_the_bridge(stages, base, embed):
    """fbank of 1 s (two rows, one masked to 0.6 s) through the JAX model
    and the port's with the bridged variables: the L2-normalised
    embeddings stage 103 writes within 1e-4 absolute, the raw ones within
    1e-4 relative to their largest entry (f32 through up to 16 residual
    blocks of convs; these random weights grow the raw values to ~1e3)."""
    audio = _audio(1)
    lens = np.array([SR, 9600], np.int32)
    feats, flens = jfbank.kaldi_fbank(jnp.asarray(audio), jnp.asarray(lens))
    jmodel = jspk.SpeakerResNet34(embed_dim=embed, base_channels=base, stages=stages)
    variables = _flax_variables(jmodel, feats, flens, 2)
    want = np.asarray(jax.jit(jmodel.apply)(variables, feats, flens))
    model = pspk.SpeakerResNet34(embed_dim=embed, base_channels=base, stages=stages)
    model.load_state_dict(flax_speaker_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(flens)))
    assert got.shape == (2, embed)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    unit = lambda e: e / np.linalg.norm(e, axis=-1, keepdims=True)
    np.testing.assert_allclose(unit(got), unit(want), rtol=0, atol=1e-4)


def test_onnx_import_equals_jax_and_the_oracle(tmp_path):
    """A wespeaker-layout torch ResNet (``tests/test_onnx_import.py``'s
    oracle: conv over (freq, time), channel-major pooling) written as ONNX
    by the test: the port's ``map_onnx_to_torch`` and JAX's
    ``map_onnx_to_flax`` of the same file give the oracle's embeddings
    (unmasked pooling, which the port's pooling over every frame equals),
    1e-4 absolute; masked to a shorter row, the port agrees with JAX."""
    stages, base, embed, n_mels = (1, 1, 1, 1), 4, 8, 80
    net = _randomized_oracle(stages, base, embed, n_mels, seed=3)
    path = tmp_path / "resnet.onnx"
    path.write_bytes(encode_onnx({k: v.detach().numpy() for k, v in net.state_dict().items()}))
    inits = pspk.load_onnx_weights(str(path))
    feats = np.random.default_rng(5).standard_normal((2, 40, n_mels)).astype(np.float32)
    flens = np.array([40, 27], np.int32)
    full = torch.full((2,), 40)
    model = pspk.SpeakerResNet34(embed_dim=embed, base_channels=base, stages=stages)
    model.load_state_dict(pspk.map_onnx_to_torch(inits, model), strict=True)
    jmodel = jspk.SpeakerResNet34(embed_dim=embed, base_channels=base, stages=stages)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(feats))
    variables = jspk.map_onnx_to_flax(jspk.load_onnx_weights(str(path)), template, stages=stages)
    with torch.no_grad():
        oracle = net(torch.from_numpy(feats)).numpy()
        got = model.eval()(torch.from_numpy(feats), full).numpy()
        got_masked = model(torch.from_numpy(feats), torch.from_numpy(flens)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(feats)))
    want_masked = np.asarray(jmodel.apply(variables, jnp.asarray(feats), jnp.asarray(flens)))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_masked, want_masked, rtol=0, atol=1e-4)
    assert np.abs(got_masked[1] - got[1]).max() > 1e-3  # the mask matters
    bad = dict(inits)
    bad.pop("seg_1.bias")
    bad["extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="seg_1.bias"):
        pspk.map_onnx_to_torch(bad, model)


def _stage103_dir(root, mode):
    """Two 1-s utterances as a dir of each stage-103 source: ``train`` (a
    spk2enroll.json pool), ``eval`` (concrete enroll.scp rows), ``wav``
    (wav.scp alone), ``lazy`` (lazy enroll.scp rows and no pool)."""
    from robustsq_whisper_torch.data import kaldi_io

    d = os.path.join(root, mode)
    audio = _audio(4)
    wav = {}
    for i in range(2):
        wav[f"10{i}-0-0000"] = os.path.join(d, "wavs", f"10{i}-0-0000.wav")
        kaldi_io.write_wav(wav[f"10{i}-0-0000"], audio[i])
    mix = {f"mix{i}_spk1": p for i, p in enumerate(wav.values())}
    kaldi_io.write_scp(os.path.join(d, "wav.scp"), mix)
    if mode == "train":
        kaldi_io.write_spk2enroll(os.path.join(d, "spk2enroll.json"),
                                  {u[:3]: [(u, p)] for u, p in wav.items()})
    elif mode == "eval":
        kaldi_io.write_scp(os.path.join(d, "enroll.scp"), {m: p for m, p in mix.items()})
    elif mode == "lazy":
        kaldi_io.write_scp(os.path.join(d, "enroll.scp"), {m: f"*{u} {u[:3]}" for m, u in
                                                           zip(mix, wav)})
    return d


@pytest.mark.parametrize("mode", ["train", "eval", "wav"])
def test_stage103_sources_follow_jax(tmp_path, mode):
    """The keys stage 103 embeds: a spk2enroll.json's pool utterances, else
    concrete enroll.scp rows (keyed by the mixture), else wav.scp."""
    d = _stage103_dir(str(tmp_path), mode)
    want = {"train": ["100-0-0000", "101-0-0000"]}.get(mode, ["mix0_spk1", "mix1_spk1"])
    assert sorted(pspk.embedding_sources(d)) == want


def test_stage103_lazy_rows_alone_raise_jax_s_error(tmp_path):
    d = _stage103_dir(str(tmp_path), "lazy")
    errors = []
    for fn, kw in ((jspk.extract_embeddings_for_dir, {}),
                   (pspk.extract_embeddings_for_dir, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            fn(d, str(tmp_path / "out"), **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "only lazy rows" in errors[0]


def test_spk_embed_equals_jax_cli(tmp_path, capsys):
    """``cli.datapre spk-embed`` of both packages on a train-mode dir with a
    full-width ResNet34 (3, 4, 6, 3) / 32 / 256 ONNX file written by the
    test (``tests/test_onnx_import.py``'s oracle, 80 mels), batches padded
    to 30 s: the same JSON line and ``resnet.scp`` keys, each ``.npy`` a
    float32 (256,) L2-normalised embedding within 1e-4 of JAX's."""
    from robustsq_whisper_tpu.cli import datapre as jcli
    from robustsq_whisper_torch.cli import datapre as pcli
    from robustsq_whisper_torch.data import kaldi_io

    d = _stage103_dir(str(tmp_path), "train")
    net = _randomized_oracle((3, 4, 6, 3), 32, 256, 80, seed=1)
    onnx = str(tmp_path / "resnet34.onnx")
    with open(onnx, "wb") as f:
        f.write(encode_onnx({k: v.detach().numpy() for k, v in net.state_dict().items()}))
    lines, scps = [], []
    for cli, out, extra in ((jcli, "j", []), (pcli, "p", ["--device", "cpu"])):
        capsys.readouterr()
        assert cli.main(["spk-embed", "--data_dir", d, "--out_dir", str(tmp_path / out),
                         "--onnx_model", onnx, "--batch_size", "2", *extra]) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
        scps.append(kaldi_io.read_scp(os.path.join(d, "resnet.scp")))
    assert lines[0] == lines[1] == '{"num_utts": 2, "embed_dim": 256}'
    assert list(scps[0]) == list(scps[1]) == ["100-0-0000", "101-0-0000"]
    for u in scps[0]:
        want, got = np.load(scps[0][u]), np.load(scps[1][u])
        assert got.dtype == np.float32 and got.shape == (256,)
        assert scps[1][u] == str(tmp_path / "p" / f"{u}.npy")
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        pcli.main(["spk-embed", "--data_dir", d, "--out_dir", str(tmp_path / "q"),
                   "--onnx_model", str(tmp_path / "absent.onnx"), "--device", "cpu"])

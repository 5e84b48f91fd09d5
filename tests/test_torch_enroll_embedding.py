"""Embedding enrollment in the port against the JAX package, on the CPU.

``SpkAdapterTSEncoder`` for every adapter, the ``TSASRModel`` loss and
gradients, the dataset's ``resnet.scp`` rows, the conditional layer norms'
start from a pretrained checkpoint, one epoch of ``cli.train
--enroll_type embedding`` against JAX's loop, and ``cli.decode
--enroll_type embedding`` against the JAX CLI, text byte for byte, greedy,
beam 3, speculative and joint CTC. Each JAX module is initialised by flax
and bridged with ``convert.flax_to_state_dict``; everything is f32, and
each tolerance is stated where it is used.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.models import TSASRModel as JModel
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import TSModelConfig as JCfg
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.models.ts_encoder import SpkAdapterTSEncoder as JEnc
from robustsq_whisper_torch.convert import flax_to_state_dict, load_flax
from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig, WhisperDims
from robustsq_whisper_torch.models.ts_encoder import SpkAdapterTSEncoder

from tests.test_torch_train import _assert_grads_close

EMB = 16
DIMS = dict(
    n_mels=80, n_vocab=300, n_audio_ctx=32, n_audio_state=32, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=64, n_text_state=32, n_text_head=2, n_text_layer=1,
)
CFG = dict(vocab_size=300, sos=257, eos=258, startofprev=259, num_speakers=8,
           num_negatives=2, ctc_weight=0.3, use_specaug=False)
METHODS = {  # id: adapter knobs
    "cat": dict(adapter_method="cat"),
    "additive": dict(adapter_method="additive"),
    "film": dict(adapter_method="film", adapter_layer=2),
    "cln": dict(adapter_method="cln"),
    "cln-modulate-bias": dict(adapter_method="cln", modulate_bias=True),
    "cat-no-norm": dict(adapter_method="cat", adapter_normalize=False),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ts(**kw):
    return dict(enroll_type="embedding", enroll_size=EMB, **kw)


def _nonzero(variables, seed):
    """The variables with every leaf drawn anew (the delta heads of a
    conditional layer norm start at 0, where they would test nothing)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)
                              * (0.3 / max(1, np.shape(x)[0]) ** 0.5)), variables)


@pytest.mark.parametrize("method", list(METHODS))
def test_encoder_matches_jax(method):
    """Every adapter, on weights drawn anew (the CLN heads nonzero), with
    two frame lengths; f32 through the adapter and 2 blocks: 1e-5."""
    jenc = JEnc.from_config(JDims(**DIMS), JTS(**_ts(**METHODS[method])))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 64)).astype(np.float32)
    lens = np.array([64, 41], np.int32)
    emb = rng.standard_normal((2, EMB)).astype(np.float32)
    args = tuple(map(jnp.asarray, (mel, lens, emb)))
    variables = jenc.init(jax.random.PRNGKey(0), *args)
    variables = {**variables, "params": _nonzero(variables["params"], 1)}
    ref, ref_lens = jax.jit(jenc.apply)(variables, *args)
    tenc = load_flax(SpkAdapterTSEncoder(WhisperDims(**DIMS), TSEncoderConfig(**_ts(**METHODS[method]))),
                     variables).eval()
    with torch.inference_mode():
        got, got_lens = tenc(*map(torch.from_numpy, (mel, lens, emb)))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _batch(seed=0, b=2, text_len=8):
    rng = np.random.default_rng(seed)
    n = DIMS["n_audio_ctx"] * 2 * 160
    text = rng.integers(1, 250, (b, text_len)).astype(np.int32)
    text[1, 5:] = -1
    return {
        "speech": (rng.standard_normal((b, n)) * 0.1).astype(np.float32),
        "speech_lens": np.array([n, n - 1500], np.int32),
        "enroll_embed": rng.standard_normal((b, EMB)).astype(np.float32),
        "text": text,
        "text_lens": np.array([text_len, 5], np.int32),
        "neg_logits": np.ones((b, b), np.float32),
        "spk_labels": np.zeros((b,), np.int32),
    }


@pytest.mark.parametrize("method", ["cat", "cln"])
def test_model_loss_and_grads_match_jax(method):
    """The hybrid CTC/attention loss of the embedding model (no speaker
    losses, a prompt-free decoder): every stat to 1e-5 relative, every
    parameter's gradient to 1e-4 relative plus 1e-5 of that gradient's
    largest entry (f32 summation order through 2 + 1 layers and CTC)."""
    jmodel = JModel(JDims(**DIMS), JTS(**_ts(**METHODS[method])), JCfg(**CFG))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda k: jmodel.init(k, jb, k, 0, train=False))(jax.random.PRNGKey(0))
    variables = {**variables, "params": _nonzero(variables["params"], 2)}

    def f(params):
        return jmodel.apply({**variables, "params": params}, jb, jax.random.PRNGKey(0), 0, train=True)

    (loss_ref, stats_ref), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    model = load_flax(TSASRModel(WhisperDims(**DIMS), TSEncoderConfig(**_ts(**METHODS[method])),
                                 TSModelConfig(**CFG)), variables)
    assert model.asp is None and model.aam is None and not model.decoder.use_spk_prompt
    loss, stats = model({k: torch.from_numpy(v) for k, v in batch.items()}, None, 0, train=True)
    loss.backward()
    assert set(stats) == set(stats_ref) == {"loss", "loss_att", "loss_ctc", "acc"}
    for k, v in stats_ref.items():
        assert stats[k].item() == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    _assert_grads_close(model, flax_to_state_dict({"params": grads}), rtol=1e-4, atol_frac=1e-5)


def test_bf16_model_keeps_conditional_norms_f32():
    """``set_compute_dtype(bf16)``: the blocks and the adapter compute in
    bf16, the conditional layer norms (with their delta heads) and the
    plain ones keep f32, as the JAX model's are f32."""
    for method in ("cat", "cln"):
        model = TSASRModel(WhisperDims(**DIMS), TSEncoderConfig(**_ts(**METHODS[method])),
                           TSModelConfig(**CFG)).set_compute_dtype(torch.bfloat16)
        for name, p in model.encoder.named_parameters():
            f32 = "cln" in name or "_ln" in name or "ln_post" in name or "adapter_norm" in name
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name


# ---------------- the dataset ----------------

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets/mini_ranks.tiktoken")
DEV = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "conf/tswhisper/train_tsasr_whisper_dev_smoke.yaml")


def write_embeddings(data_dir, keys, seed, dim=EMB):
    """Random embeddings ``{data_dir}/emb/{key}.npy`` and the ``resnet.scp``
    naming them, as stage 103 writes them."""
    from robustsq_whisper_torch.data import kaldi_io

    rng = np.random.default_rng(seed)
    scp = {}
    for k in keys:
        scp[k] = os.path.join(data_dir, "emb", f"{k}.npy")
        os.makedirs(os.path.dirname(scp[k]), exist_ok=True)
        np.save(scp[k], rng.standard_normal(dim).astype(np.float32))
    kaldi_io.write_scp(os.path.join(data_dir, "resnet.scp"), scp)
    return scp


@pytest.fixture(scope="module")
def mix_dir(tmp_path_factory):
    """A ``cli.datapre overlap`` dir (lazy ``*utt spk`` rows over a
    ``spk2enroll.json``) with a ``resnet.scp`` of every pool utterance."""
    from robustsq_whisper_torch.cli import datapre
    from robustsq_whisper_torch.data import kaldi_io

    from tests.test_pipeline import _make_clean_dir

    tmp = tmp_path_factory.mktemp("emb")
    data_dir = str(tmp / "mix")
    assert datapre.main(["overlap", "--src_dir", _make_clean_dir(tmp), "--out_dir", data_dir,
                         "--num_mixtures", "4", "--seed", "0"]) == 0
    s2e = kaldi_io.read_spk2enroll(os.path.join(data_dir, "spk2enroll.json"))
    write_embeddings(data_dir, sorted(u for pairs in s2e.values() for u, _ in pairs), 0)
    return tmp, data_dir


def _datasets(data_dir, **kw):
    from robustsq_whisper_tpu.data.dataset import KaldiTSDataset as JSet
    from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import ByteTokenizer as JTok
    from robustsq_whisper_torch.data.dataset import KaldiTSDataset
    from robustsq_whisper_torch.tokenizer import ByteTokenizer

    args = dict(speech_seconds=0.64, enroll_seconds=0.32, seed=3, enroll_type="embedding", **kw)
    return JSet(data_dir, JTok(), **args), KaldiTSDataset(data_dir, ByteTokenizer(), **args)


def test_dataset_lazy_rows_equal_jax(mix_dir):
    """Lazy rows draw a same-speaker enrollment utterance, whose id keys the
    scp: every batch over two shuffled epochs is JAX's, array for array
    (the same numpy draws in the same order), and carries no enrollment
    audio."""
    _, data_dir = mix_dir
    jset, pset = _datasets(data_dir)
    for _ in range(2):
        for jb, pb in zip(jset.batches(4), pset.batches(4)):
            assert jb.keys() == pb.keys() and "enroll" not in pb and "enroll_lens" not in pb
            assert pb["enroll_embed"].shape == (4, EMB) and pb["enroll_embed"].dtype == np.float32
            for k in jb:
                np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)


def test_dataset_direct_rows_and_prefix(mix_dir, tmp_path):
    """Concrete ``enroll.scp`` rows key the scp by the mixture utt, read
    from ``{enroll_prefix}.scp``."""
    import shutil

    from robustsq_whisper_torch.data import kaldi_io

    d = str(tmp_path / "direct")
    shutil.copytree(mix_dir[1], d)
    wav = kaldi_io.read_scp(os.path.join(d, "wav.scp"))
    kaldi_io.write_scp(os.path.join(d, "enroll.scp"), {u: p for u, p in wav.items()})
    scp = write_embeddings(d, sorted(wav), 1)
    os.rename(os.path.join(d, "resnet.scp"), os.path.join(d, "xvec.scp"))
    _, pset = _datasets(d, enroll_prefix="xvec")
    batch = next(pset.batches(len(wav), shuffle=False))
    for i, u in enumerate(batch["utt_ids"]):
        np.testing.assert_array_equal(batch["enroll_embed"][i], np.load(scp[u]))


def test_dataset_embedding_enrollment_errors(mix_dir, tmp_path):
    """Both packages raise the same errors: FileNotFoundError for a missing
    scp (at construction), KeyError for a key it lacks (at the batch)."""
    import shutil

    from robustsq_whisper_tpu.data.dataset import KaldiTSDataset as JSet
    from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import ByteTokenizer as JTok
    from robustsq_whisper_torch.data.dataset import KaldiTSDataset
    from robustsq_whisper_torch.tokenizer import ByteTokenizer

    d = str(tmp_path / "missing")
    shutil.copytree(mix_dir[1], d)
    os.remove(os.path.join(d, "resnet.scp"))
    found = []
    for cls, tok in ((JSet, JTok()), (KaldiTSDataset, ByteTokenizer())):
        with pytest.raises(FileNotFoundError) as e:
            cls(d, tok, enroll_type="embedding")
        found.append(str(e.value))
    assert found[0] == found[1] and "resnet.scp" in found[0]
    write_embeddings(d, ["nobody"], 2)
    keys = []
    for ds in _datasets(d):
        with pytest.raises(KeyError) as e:
            next(ds.batches(2, shuffle=False))
        keys.append(str(e.value))
    assert keys[0] == keys[1] and "resnet.scp has no embedding for" in keys[0]


# ---------------- the conditional layer norms' start ----------------


def _dev_exp(pkg, **ts):
    import dataclasses

    if pkg == "jax":
        from robustsq_whisper_tpu.utils.config import load_experiment
    else:
        from robustsq_whisper_torch.utils.config import load_experiment
    exp = load_experiment(DEV)
    return dataclasses.replace(exp, ts=dataclasses.replace(exp.ts, **_ts(**ts)))


def test_cln_starts_from_pretrained_block0_norms(tmp_path):
    """``build_model(pretrained=...)`` with the ``cln`` adapter against the
    JAX ``build_model_and_variables``: the conditional layer norms are the
    file's block-0 ``attn_ln`` / ``mlp_ln``, their delta heads 0, the
    unrolled Whisper blocks the file's (JAX's ``blocks_{i}``), exactly."""
    import dataclasses

    from robustsq_whisper_tpu.cli import train as jtrain
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.models.whisper import load as pload

    from tests.test_openai_checkpoint import _make_openai_pt

    exp, jexp = _dev_exp("torch", adapter_method="cln"), _dev_exp("jax", adapter_method="cln")
    path = str(tmp_path / "dev.pt")
    _make_openai_pt(path, JDims(**{**dataclasses.asdict(jexp.resolved_dims()), "n_vocab": 300}),
                    seed=7)
    b, n = 2, int(exp.speech_seconds * 16000)
    rng = np.random.default_rng(0)
    batch = {"speech": rng.standard_normal((b, n)).astype(np.float32) * 0.1,
             "speech_lens": np.full((b,), n, np.int32),
             "enroll_embed": rng.standard_normal((b, EMB)).astype(np.float32),
             "text": np.full((b, 8), 5, np.int32), "text_lens": np.full((b,), 8, np.int32),
             "neg_logits": np.ones((b, b), np.float32), "spk_labels": np.zeros((b,), np.int32)}
    _, variables = jtrain.build_model_and_variables(jexp, jax.random.PRNGKey(0), path, batch)
    jsd = flax_to_state_dict({"params": variables["params"]})
    sd = build_model(exp, seed=0, device="cpu", pretrained=path).state_dict()
    _, enc_file, _ = pload.load_openai_checkpoint(path)
    for cln, ln in (("attn_cln", "attn_ln"), ("mlp_cln", "mlp_ln")):
        for k in ("weight", "bias"):
            want = enc_file[f"blocks.0.{ln}.{k}"]
            assert torch.equal(sd[f"encoder.{cln}.{k}"], want)
            assert torch.equal(jsd[f"encoder.{cln}.{k}"], want)
        for k in ("weight", "bias"):
            assert not sd[f"encoder.{cln}.delta_scale.{k}"].any()
    assert "encoder.encoder.blocks.0.attn_ln.weight" not in sd
    blocks = [k for k in sd if k.startswith("encoder.encoder.blocks.")]
    assert len(blocks) == len([k for k in enc_file if k.startswith("blocks.")]) - 4
    for k in blocks:
        assert torch.equal(sd[k], enc_file[k[len("encoder.encoder."):]]), k
        assert torch.equal(sd[k], jsd[k]), k


# ---------------- cli.train --enroll_type embedding ----------------


@pytest.fixture(scope="module")
def loop_dirs(tmp_path_factory):
    """``test_torch_train_cli``'s train and valid dirs (lazy rows, one
    utterance a target speaker) with a ``resnet.scp`` of every pool
    utterance, and its config with embedding enrollment."""
    from robustsq_whisper_torch.data import kaldi_io

    from tests.test_torch_train_cli import CONFIG, write_dir

    tmp = tmp_path_factory.mktemp("emb_loop")
    out = {"tmp": tmp}
    for split, speakers, seed in (("train", (100, 101, 102, 103), 0), ("valid", (104, 105), 1)):
        d = write_dir(str(tmp / split), speakers, seed)
        pool = kaldi_io.read_spk2enroll(os.path.join(d, "spk2enroll.json"))
        write_embeddings(d, sorted(u for pairs in pool.values() for u, _ in pairs), seed + 5)
        out[split] = d
    # the config with embedding enrollment, and with audio enrollment (for
    # the --enroll_type flag) at the embeddings' size
    for name, lines in (("config", f"  enroll_type: embedding\n  enroll_size: {EMB}\n"),
                        ("audio_config", f"  enroll_size: {EMB}\n")):
        out[name] = str(tmp / f"{name}.yaml")
        with open(out[name], "w") as f:
            f.write(CONFIG.replace("{mode}", "full").replace(
                "encoder_conf:\n", "encoder_conf:\n" + lines))
    return out


@pytest.fixture(scope="module")
def loops(loop_dirs):
    """One epoch of both packages' ``run_training`` with the validation
    pass, from the JAX init (as the JAX ``cli.train`` makes it): the logged
    records, the final states and the checkpoint dirs."""
    import jax.numpy as jnp

    from robustsq_whisper_tpu.data.dataset import KaldiTSDataset as JSet
    from robustsq_whisper_tpu.train.loop import LoopConfig as JLoop
    from robustsq_whisper_tpu.train.loop import run_training as jrun
    from robustsq_whisper_tpu.utils.config import load_experiment as jload
    from robustsq_whisper_torch.data.dataset import KaldiTSDataset
    from robustsq_whisper_torch.tokenizer.whisper_tokenizer import load_tokenizer
    from robustsq_whisper_torch.train.loop import LoopConfig, run_training
    from robustsq_whisper_torch.utils.config import load_experiment

    from tests.test_torch_train_cli import TokenIds

    d = loop_dirs
    jexp, exp = jload(d["config"]), load_experiment(d["config"])
    assert exp.ts.enroll_type == jexp.ts.enroll_type == "embedding"
    tok = TokenIds(load_tokenizer(RANKS))
    kw = dict(speech_seconds=exp.speech_seconds, enroll_seconds=exp.enroll_seconds,
              num_speakers=exp.model.num_speakers, seed=0, enroll_type="embedding")
    jtrain, jvalid = (JSet(d[s], tok, **kw) for s in ("train", "valid"))
    jmodel = JModel(jexp.resolved_dims(), jexp.ts, jexp.model, dtype=jnp.float32)
    first = {k: jnp.asarray(v) for k, v in next(jtrain.batches(2, shuffle=False)).items()
             if k != "utt_ids"}
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r: jmodel.init(r, first, r, 0, train=False))(rng)
    model = load_flax(TSASRModel(exp.resolved_dims(), exp.ts, exp.model), variables)
    ptrain, pvalid = (KaldiTSDataset(d[s], tok, **kw) for s in ("train", "valid"))
    next(ptrain.batches(2, shuffle=False))  # the draws of JAX's init batch
    loop = dict(num_epochs=1, batch_size=2, log_every=1, ckpt_every_steps=0, nbest=2)
    out = {"jdir": str(d["tmp"] / "jexp" / "checkpoints"), "pdir": str(d["tmp"] / "pexp_loop"),
           "jrec": [], "prec": []}
    out["jstate"] = jrun(jmodel, jtrain, variables, jexp.train,
                         JLoop(ckpt_dir=out["jdir"], **loop), rng=rng,
                         metrics_hook=lambda s, v: out["jrec"].append((s, v)),
                         valid_dataset=jvalid)
    out["state"] = run_training(model, ptrain, exp.train, LoopConfig(ckpt_dir=out["pdir"], **loop),
                                metrics_hook=lambda s, v: out["prec"].append((s, v)),
                                valid_dataset=pvalid, device="cpu")
    return out


def test_loop_equals_jax(loops):
    """Every logged stat to 1e-4 relative (the gradient norm to 5e-4), the
    final weights to 1e-5 absolute, and ``nbest.json`` byte for byte (the
    tolerances of ``test_torch_train_cli``)."""
    jrec, prec = loops["jrec"], loops["prec"][:-1]  # the port's last line: seconds
    assert [s for s, _ in prec] == [s for s, _ in jrec] == [1, 2, 2]
    for (step, got), (_, want) in zip(prec, jrec):
        assert got.keys() == want.keys(), step
        for k, v in want.items():
            if k not in ("steps_per_sec", "epoch"):
                assert got[k] == pytest.approx(float(v), rel=5e-4 if k == "grad_norm" else 1e-4,
                                               abs=1e-6), (step, k)
    ref = flax_to_state_dict({"params": loops["jstate"].params})
    for name, p in loops["state"].model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    with open(os.path.join(loops["jdir"], "nbest.json"), "rb") as f, \
            open(os.path.join(loops["pdir"], "nbest.json"), "rb") as g:
        assert f.read() == g.read()


def test_cli_train_embedding_runs(loop_dirs, tmp_path):
    """``cli.train.main --enroll_type embedding --device cpu`` over a config
    of audio enrollment, one epoch with a valid dir and the valid WER: the
    stats are finite and the epoch's checkpoint is written."""
    from robustsq_whisper_torch.cli import train as ptrain
    from robustsq_whisper_torch.train.checkpoint import all_steps

    rec = []
    exp = str(tmp_path / "exp")
    assert ptrain.main(["--config", loop_dirs["audio_config"], "--train_dir", loop_dirs["train"],
                        "--valid_dir", loop_dirs["valid"], "--expdir", exp, "--device", "cpu", "--batch_size",
                        "2", "--num_epochs", "1", "--valid_wer_utts", "2", "--enroll_type",
                        "embedding", "--tokenizer_assets", RANKS],
                       metrics_hook=lambda s, v: rec.append((s, v))) == 0
    valid = [v for _, v in rec if "valid.acc" in v]
    assert len(valid) == 1 and {"valid.wer", "valid.loss"} <= valid[0].keys()
    assert all(np.isfinite(v) for _, r in rec for v in r.values())
    assert all_steps(os.path.join(exp, "checkpoints")) == [2]


# ---------------- cli.decode --enroll_type embedding ----------------


@pytest.fixture(scope="module")
def trained(loop_dirs, loops):
    """The JAX loop's last checkpoint (``restore_weights``) in the port's
    format (``flax_to_state_dict``, ``save_checkpoint``), and a beam-3
    inference yaml."""
    from robustsq_whisper_tpu.train.checkpoint import restore_weights
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.train import create_train_state
    from robustsq_whisper_torch.train.checkpoint import save_checkpoint
    from robustsq_whisper_torch.utils.config import load_experiment

    tmp = loop_dirs["tmp"]
    params, buffers, _, step, epoch = restore_weights(loops["jdir"])
    exp = load_experiment(loop_dirs["config"])
    model = build_model(exp, seed=0, device="cpu")
    model.load_state_dict(flax_to_state_dict({"params": params, **buffers}), strict=True)
    state = create_train_state(model, exp.train, device="cpu")
    state.step = step
    save_checkpoint(str(tmp / "pexp" / "checkpoints"), step, state, epoch)
    beam3 = str(tmp / "beam3.yaml")
    with open(beam3, "w") as f:
        f.write("decode_conf:\n  beam_size: 3\n  max_new_tokens: 8\n")
    return dict(tmp=tmp, data_dir=loop_dirs["train"], config=loop_dirs["audio_config"],
                jexp=str(tmp / "jexp"), pexp=str(tmp / "pexp"), beam3=beam3)


DECODE_CASES = {
    "greedy": (),
    "beam3": ("--inference_config", "{beam3}"),
    "speculative": ("--speculative_gamma", "2", "--draft_layers", "1"),
    "ctc-beam3": ("--ctc_weight", "0.3", "--inference_config", "{beam3}"),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_equals_jax_cli(trained, case):
    """Both CLIs decode the dir from one checkpoint: ``text`` byte for
    byte, and every ``score.txt`` metric but the real-time factor equal."""
    from robustsq_whisper_tpu.cli import decode as jdecode
    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.data import kaldi_io

    from tests.test_torch_cli import BEAM1, _scores

    t = trained
    extra = [a.format(beam3=t["beam3"]) for a in DECODE_CASES[case]]

    def argv(expdir, out):
        return ["--config", t["config"], "--inference_config", BEAM1, "--data_dir", t["data_dir"],
                "--expdir", expdir, "--output_dir", out, "--batch_size", "4", "--use_ave",
                "false", "--tokenizer_assets", RANKS, "--enroll_type", "embedding", *extra]

    jout, pout = (str(t["tmp"] / f"{k}_{case}") for k in ("jdec", "pdec"))
    assert jdecode.main(argv(t["jexp"], jout)) == 0
    assert pdecode.main(argv(t["pexp"], pout) + ["--device", "cpu"]) == 0
    with open(os.path.join(jout, "text")) as f, open(os.path.join(pout, "text")) as g:
        assert g.read() == f.read()
    hyps = kaldi_io.read_scp(os.path.join(pout, "text"))
    assert len(hyps) == 4 and any(h.strip() for h in hyps.values())
    js, ps = _scores(jout), _scores(pout)
    assert ps.pop("rtf") and js.pop("rtf")
    assert ps == js and {"wer", "cer"} <= ps.keys()
    if case == "speculative":
        assert float(ps["spec_chunks"]) > 0


@pytest.mark.parametrize("flags,match", [
    (("--model_parallel", "2"), "--model_parallel serving of the embedding-enrollment encoder"),
    (("--long_audio", "true"), "--long_audio windows share one Qformer speaker prompt"),
])
def test_decode_refusals_are_jax_s(mix_dir, flags, match, capsys):
    """The JAX CLI's refusals with its messages: tensor-parallel serving and
    long-audio windows of the embedding encoder."""
    from robustsq_whisper_torch.cli import decode as pdecode

    with pytest.raises(SystemExit) as e:
        pdecode.main(["--config", DEV, "--data_dir", mix_dir[1], "--output_dir",
                      str(mix_dir[0] / "refused"), "--device", "cpu", "--enroll_type",
                      "embedding", *flags])
    assert e.value.code == 2 and match in capsys.readouterr().err

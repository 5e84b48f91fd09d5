"""The port's ``cli.decode`` against the JAX package's on one checkpoint.

The JAX ``cli.train`` trains the dev smoke config on a ``cli.datapre
overlap`` data dir (12 epochs instead of the config's 1, so the greedy
transcripts are words rather than blanks); its checkpoint is read with the
JAX ``restore_weights``, mapped with ``convert.flax_to_state_dict`` and
saved with the port's ``save_checkpoint``. Then both CLIs decode the data
dir with the beam-1 inference yaml and the mini BPE ranks: the ``text``
files must be identical and every ``score.txt`` metric equal but the
real-time factor, greedy, speculative with a self-draft and with a
distilled draft (the same draft-acceptance counters), joint CTC/attention
at beam 3 and long-audio windows. The JAX ``cli.distill`` writes the
distilled draft; the port's copy of it is JAX's ``load_draft``, mapped with
``convert.flax_to_state_dict`` and saved with the port's ``save_draft``.
The port's own ``cli.distill`` on the same checkpoint must give JAX's
draft weights."""

import os
import shutil

import pytest
import torch

from robustsq_whisper_tpu.data import kaldi_io

from tests.test_pipeline import _make_clean_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "conf/tswhisper/train_tsasr_whisper_dev_smoke.yaml")
BEAM1 = os.path.join(REPO, "conf/tswhisper/decode_asr_whisper_beam1.yaml")
RANKS = os.path.join(REPO, "tests/assets/mini_ranks.tiktoken")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from robustsq_whisper_tpu.cli import datapre
    from robustsq_whisper_tpu.cli import train as jtrain
    from robustsq_whisper_tpu.train.checkpoint import restore_weights
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.convert import flax_to_state_dict
    from robustsq_whisper_torch.train import create_train_state
    from robustsq_whisper_torch.train.checkpoint import save_checkpoint
    from robustsq_whisper_torch.utils.config import load_experiment

    tmp = tmp_path_factory.mktemp("cli")
    data_dir = str(tmp / "dump" / "train")
    assert datapre.main([
        "overlap", "--src_dir", _make_clean_dir(tmp), "--out_dir", data_dir,
        "--num_mixtures", "4", "--seed", "0",
    ]) == 0
    config = str(tmp / "dev_smoke_12.yaml")
    with open(CONFIG) as f:
        text = f.read()
    assert "num_epochs: 1\n" in text
    with open(config, "w") as f:
        f.write(text.replace("num_epochs: 1\n", "num_epochs: 12\n"))
    jexp = str(tmp / "jexp")
    assert jtrain.main(["--config", config, "--train_dir", data_dir, "--expdir", jexp]) == 0

    params, buffers, _, step, epoch = restore_weights(os.path.join(jexp, "checkpoints"))
    exp = load_experiment(config)
    model = build_model(exp, seed=0, device="cpu")
    model.load_state_dict(flax_to_state_dict({"params": params, **buffers}), strict=True)
    state = create_train_state(model, exp.train, device="cpu")
    state.step = step
    pexp = str(tmp / "pexp")
    save_checkpoint(os.path.join(pexp, "checkpoints"), step, state, epoch)
    return dict(tmp=tmp, data_dir=data_dir, config=config, jexp=jexp, pexp=pexp)


@pytest.fixture(scope="module")
def drafts(trained):
    """The JAX ``cli.distill`` draft of the trained checkpoint, the port's
    copy of it, and the port's ``cli.distill`` draft of the same
    checkpoint (5 steps over 4 utterances)."""
    from robustsq_whisper_tpu.cli import distill as jdistill_cli
    from robustsq_whisper_tpu.train.distill import load_draft as j_load_draft
    from robustsq_whisper_torch.cli import distill as pdistill_cli
    from robustsq_whisper_torch.convert import flax_to_state_dict
    from robustsq_whisper_torch.train.distill import save_draft

    t = trained
    argv = lambda expdir, out: [
        "--config", t["config"], "--expdir", expdir, "--data_dir", t["data_dir"],
        "--out", out, "--tokenizer_assets", RANKS, "--draft_layers", "1", "--steps", "5",
        "--max_items", "4", "--batch_size", "4", "--max_new_tokens", "8",
    ]
    jdraft, pdraft = str(t["tmp"] / "jdraft"), str(t["tmp"] / "pdraft")
    assert jdistill_cli.main(argv(t["jexp"], jdraft)) == 0
    assert pdistill_cli.main(argv(t["pexp"], pdraft) + ["--device", "cpu"]) == 0
    jvars, jmeta = j_load_draft(jdraft)
    copy = save_draft(str(t["tmp"] / "jdraft_port"), flax_to_state_dict(jvars), jmeta)
    return dict(jax=jdraft, port=pdraft, copy=copy, jvars=jvars, jmeta=jmeta)


def _argv(t, expdir, out, *extra):
    return [
        "--config", t["config"], "--inference_config", BEAM1, "--data_dir", t["data_dir"],
        "--expdir", expdir, "--output_dir", out, "--batch_size", "4",
        "--tokenizer_assets", RANKS, *extra,
    ]


def _scores(out):
    with open(os.path.join(out, "score.txt")) as f:
        return dict(line.split() for line in f)


CASES = {
    "greedy": (),
    "speculative": ("--speculative_gamma", "2", "--draft_layers", "1"),
    "ctc-beam3": ("--ctc_weight", "0.3", "--inference_config", "{beam3}"),
    # windows of the config's 0.64 s, so each utterance spans several
    "long-audio": ("--long_audio", "true", "--chunk_seconds", "0.64"),
    # the default 30 s windows: one a second-long utterance, mostly padding,
    # and 200-token rows whose close margins show any difference in the
    # enrollments the two CLIs draw
    "long-audio-30s": ("--long_audio", "true"),
    "draft": ("--speculative_gamma", "2", "--draft_path", "{draft}"),
    # W8A8 step weights: the token steps through qmatmul, the prefill dense
    "int8-weights": ("--int8_weights", "true"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_decode_equals_jax_cli(trained, request, monkeypatch, case):
    import jax

    from robustsq_whisper_tpu.cli import decode as jdecode
    from robustsq_whisper_tpu.train import checkpoint as jckpt
    from robustsq_whisper_torch.cli import decode as pdecode

    t = trained
    if case == "draft":
        # The JAX serving restore leaves the buffers on every device they
        # were saved from (eight virtual CPU devices here) while the draft
        # goes to one, and the JAX draft path is single-device: keep the
        # restored weights on one device, as on a one-chip host.
        restore = jckpt.restore_serving_variables
        monkeypatch.setattr(jckpt, "restore_serving_variables", lambda *a, **kw: (
            lambda v, *rest: (jax.device_put(v, jax.devices()[0]), *rest))(*restore(*a, **kw)))
    beam3 = str(t["tmp"] / "beam3.yaml")
    with open(beam3, "w") as f:
        f.write("decode_conf:\n  beam_size: 3\n  max_new_tokens: 8\n")
    drafts = request.getfixturevalue("drafts") if case == "draft" else {}

    def extra(side):
        return [a.format(beam3=beam3, draft=drafts.get(side, "")) for a in CASES[case]]

    jout, pout = (str(t["tmp"] / f"{k}_{case}") for k in ("jdec", "pdec"))
    assert jdecode.main(_argv(t, t["jexp"], jout, *extra("jax"))) == 0
    assert pdecode.main(_argv(t, t["pexp"], pout, "--device", "cpu", *extra("copy"))) == 0
    with open(os.path.join(jout, "text")) as f, open(os.path.join(pout, "text")) as g:
        jtext, ptext = f.read(), g.read()
    assert ptext == jtext
    hyps = kaldi_io.read_scp(os.path.join(pout, "text"))
    assert len(hyps) == 8 and any(h.strip() for h in hyps.values())
    js, ps = _scores(jout), _scores(pout)
    assert ps.pop("rtf") and js.pop("rtf")
    assert ps == js
    assert {"wer", "cer"} <= ps.keys()
    if "--speculative_gamma" in CASES[case]:
        assert float(ps["spec_chunks"]) > 0


def test_serve_takes_int8_weights(trained, monkeypatch):
    """``cli.serve --int8_weights true`` builds an engine whose token steps
    run W8A8 (through ``qmatmul``'s plain version on the CPU) and serves
    a text."""
    import numpy as np

    from robustsq_whisper_torch.cli import serve as pserve
    from robustsq_whisper_torch.ops import quant

    args = pserve.parse_args([
        "--config", trained["config"], "--inference_config", BEAM1, "--expdir",
        trained["pexp"], "--tokenizer_assets", RANKS, "--batch_size", "2",
        "--device", "cpu", "--int8_weights", "true",
    ])
    engine, _ = pserve.build_engine(args)
    assert engine.dcfg.quantize_weights
    calls = []
    plain = quant.qmatmul_plain
    monkeypatch.setattr(quant, "qmatmul_plain", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    rng = np.random.default_rng(0)
    pair = tuple((rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
                 for s in (1.0, 0.5))
    texts = engine.transcribe([pair])
    assert len(texts) == 1 and isinstance(texts[0], str) and calls


def test_serve_takes_a_draft(trained, drafts):
    """``cli.serve --speculative_gamma 2 --draft_path`` builds an engine
    that decodes speculatively with the distilled draft and serves the
    greedy engine's text, token for token (the speculative contract)."""
    import numpy as np

    from robustsq_whisper_torch.cli import serve as pserve

    def engine(*extra):
        return pserve.build_engine(pserve.parse_args([
            "--config", trained["config"], "--inference_config", BEAM1, "--expdir",
            trained["pexp"], "--tokenizer_assets", RANKS, "--batch_size", "2",
            "--device", "cpu", *extra]))[0]

    spec = engine("--speculative_gamma", "2", "--draft_path", drafts["copy"])
    greedy = engine()
    assert spec.dcfg.speculative_gamma == 2 and greedy.dcfg.speculative_gamma == 0
    rng = np.random.default_rng(1)
    pairs = [tuple((rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
                   for s in (1.0 + 0.5 * i, 0.5)) for i in range(2)]
    with torch.inference_mode():
        staged = spec.stage(pairs)
        stats = spec.run(*spec.encode(*staged))[2]
    assert int(stats["chunks"].sum()) > 0
    texts = spec.transcribe(pairs)
    assert texts == greedy.transcribe(pairs) and all(texts)


def test_distill_equals_jax_cli(drafts):
    """The port's ``cli.distill`` on the checkpoint JAX distilled from: the
    same corpus and meta (the checkpoint's own path aside; the loss to
    1e-5) and the same draft weights, each within 1e-5 of JAX's (the bound
    ``test_torch_distill.py`` holds ``distill_draft`` to): the two CLIs
    draw the same enrollments, and the frontends' f32 rounding moves no
    weight that far. The frozen embeddings are the teacher's, exactly."""
    from robustsq_whisper_torch.convert import flax_to_state_dict
    from robustsq_whisper_torch.train.distill import load_draft

    sd, meta = load_draft(drafts["port"])
    want = flax_to_state_dict(drafts["jvars"])
    assert sd.keys() == want.keys()
    for k, v in sd.items():
        if ".blocks." in k or ".ln." in k:  # the trained weights
            assert float((v - want[k]).abs().max()) <= 1e-5, k
        else:
            assert torch.equal(v, want[k]), k
    jmeta = dict(drafts["jmeta"])
    assert meta.pop("teacher_ckpt").endswith("pexp/checkpoints")
    assert jmeta.pop("teacher_ckpt").endswith("jexp/checkpoints")
    assert meta.keys() == jmeta.keys() and meta["corpus_items"] == 4
    for k, v in meta.items():
        assert v == pytest.approx(jmeta[k], abs=1e-5 if k == "final_loss" else 0), k


def test_decode_from_random_init_and_ave(trained, tmp_path):
    """No checkpoint: the seeded random init. An ``ave`` checkpoint (here
    the random init's) wins with ``--use_ave`` (the default) and is
    ignored with ``--use_ave false``."""
    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.train import create_train_state
    from robustsq_whisper_torch.train.checkpoint import save_checkpoint
    from robustsq_whisper_torch.utils.config import load_experiment

    t = trained

    def text(expdir, name, *extra):
        out = str(tmp_path / name)
        assert pdecode.main(_argv(t, expdir, out, "--device", "cpu", *extra)) == 0
        with open(os.path.join(out, "text")) as f:
            return f.read()

    random_init = text(str(tmp_path / "empty"), "r")
    trained_text = text(t["pexp"], "t")
    assert random_init != trained_text and random_init.count("\n") == 8
    ave = tmp_path / "ave"
    shutil.copytree(os.path.join(t["pexp"], "checkpoints"), ave / "checkpoints")
    exp = load_experiment(t["config"])
    state = create_train_state(build_model(exp, seed=0, device="cpu"), exp.train, device="cpu")
    save_checkpoint(str(ave / "checkpoints" / "ave"), 0, state, epoch=0)
    assert text(str(ave), "a") == random_init
    assert text(str(ave), "b", "--use_ave", "false") == trained_text


def test_model_parallel_must_divide_the_world(capsys):
    """``--model_parallel 2`` in one process stops with the JAX CLI's
    divisibility message (an assert there, ``cli/decode.py``), for both
    CLIs."""
    import inspect

    from robustsq_whisper_tpu.cli import decode as jdecode
    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.cli import serve as pserve

    assert 'f"--model_parallel {tp} must divide {jax.device_count()} devices"' in (
        inspect.getsource(jdecode))
    with pytest.raises(SystemExit) as e:
        pdecode.main(["--config", CONFIG, "--data_dir", "/nonexistent", "--output_dir",
                      "/nonexistent", "--device", "cpu", "--model_parallel", "2"])
    assert e.value.code == 2
    assert "--model_parallel 2 must divide 1 devices" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        pserve.parse_args(["--config", CONFIG, "--device", "cpu", "--model_parallel", "2"])
    assert "--model_parallel 2 must divide 1 devices" in capsys.readouterr().err


def test_tp_embedding_refusal_keeps_the_jax_message():
    """Tensor-parallel serving of the embedding-enrollment encoder stops
    with the JAX pipeline's NotImplementedError, word for word."""
    import dataclasses

    from robustsq_whisper_tpu.decode import pipeline as jpipe
    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.models import SpkAdapterTSEncoder, TSDecoder, TSEncoderConfig
    from robustsq_whisper_torch.models import WhisperDims

    class Axis:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    class Mesh:  # two model ranks, one data rank
        def __getitem__(self, axis):
            return Axis(2 if axis == "model" else 1)

    dims = WhisperDims(n_audio_state=32, n_audio_head=2, n_audio_layer=1, n_text_state=32,
                       n_text_head=2, n_text_layer=1, n_vocab=50)
    enc = SpkAdapterTSEncoder(dims, TSEncoderConfig(enroll_type="embedding", enroll_size=8))
    with pytest.raises(NotImplementedError) as e:
        build_decode_fns(enc, TSDecoder(dims, use_spk_prompt=False), DecodeConfig(),
                         mesh=Mesh(), device="cpu")
    from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
    from robustsq_whisper_tpu.models import SpkAdapterTSEncoder as JEnc
    from robustsq_whisper_tpu.models import TSDecoder as JDec
    from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
    from robustsq_whisper_tpu.models import WhisperDims as JDims

    class JMesh:
        shape = {"data": 1, "model": 2}

    jdims = JDims(**dataclasses.asdict(dims))
    with pytest.raises(NotImplementedError) as je:
        jpipe._build_embedding_decode_fns(
            JEnc.from_config(jdims, JTS(enroll_type="embedding", enroll_size=8)), None,
            JDec(jdims, use_spk_prompt=False), None, JDecodeConfig(), JMesh())
    assert str(e.value) == str(je.value)


def test_serve_unsupported_flags_stop(capsys):
    from robustsq_whisper_torch.cli import serve as pserve

    for flag, value in (("--compile_cache", "/tmp/x"),):
        with pytest.raises(SystemExit):
            pserve.parse_args(["--config", CONFIG, flag, value])
        assert flag in capsys.readouterr().err


def test_decode_and_serve_on_two_ranks(trained, tmp_path):
    """Under two gloo ranks (``tests/_torch_dist.py``): ``cli.decode
    --data_parallel true`` and ``--model_parallel 2`` write the ``text`` and
    ``score.txt`` (but its rtf) of the JAX CLI's same flags, byte for byte
    (the JAX CLI over the suite's 8 virtual devices); ``cli.serve``, rank 0
    serving HTTP and rank 1 following, answers requests with the texts of
    one process's engine."""
    from robustsq_whisper_tpu.cli import decode as jdecode
    from robustsq_whisper_torch.cli import serve as pserve
    from robustsq_whisper_torch.serve import audio_from_bytes

    from ._torch_dist import launch
    from .test_torch_serve import _wav, _wav_bytes

    t = trained
    runs = {"dp": ("--data_parallel", "true"), "tp": ("--model_parallel", "2")}
    decode = []
    for name, flags in runs.items():
        assert jdecode.main(_argv(t, t["jexp"], str(tmp_path / f"j{name}"), *flags)) == 0
        decode.append(_argv(t, t["pexp"], str(tmp_path / f"p{name}"), "--device", "cpu", *flags))
    serve = ["--config", t["config"], "--inference_config", BEAM1, "--expdir", t["pexp"],
             "--tokenizer_assets", RANKS, "--batch_size", "2", "--device", "cpu"]
    wavs = [(_wav_bytes(_wav(10 + i, 0.2 + 0.1 * i)), _wav_bytes(_wav(30 + i, 0.16)))
            for i in range(3)]
    torch.save({"decode": decode, "serve": serve, "requests": wavs}, tmp_path / "inputs.pt")
    launch("cli", 2, str(tmp_path), timeout=240)
    for name in runs:
        jout, pout = str(tmp_path / f"j{name}"), str(tmp_path / f"p{name}")
        with open(os.path.join(jout, "text")) as f, open(os.path.join(pout, "text")) as g:
            assert g.read() == f.read(), name
        js, ps = _scores(jout), _scores(pout)
        assert ps.pop("rtf") and js.pop("rtf")
        assert ps == js, name
    got = torch.load(tmp_path / "out-0.pt", weights_only=False)["texts"]
    engine, _ = pserve.build_engine(pserve.parse_args(serve))
    want = [engine.transcribe([(audio_from_bytes(s), audio_from_bytes(e))])[0] for s, e in wavs]
    assert got == want and any(want)


def _serve_on_two_ranks(t, tmp_path, flags=(), **inp):
    """``cli.serve`` under two gloo ranks (``_torch_dist._cli``) answering
    two requests; returns rank 0's texts and one process's engine's."""
    from robustsq_whisper_torch.cli import serve as pserve
    from robustsq_whisper_torch.serve import audio_from_bytes

    from ._torch_dist import launch
    from .test_torch_serve import _wav, _wav_bytes

    serve = ["--config", t["config"], "--inference_config", BEAM1, "--expdir", t["pexp"],
             "--tokenizer_assets", RANKS, "--batch_size", "2", "--device", "cpu", *flags]
    wavs = [(_wav_bytes(_wav(40 + i, 0.3)), _wav_bytes(_wav(50 + i, 0.16))) for i in range(2)]
    torch.save({"serve": serve, "requests": wavs, **inp}, tmp_path / "inputs.pt")
    launch("cli", 2, str(tmp_path), timeout=120)
    got = torch.load(tmp_path / "out-0.pt", weights_only=False)["texts"]
    engine, _ = pserve.build_engine(pserve.parse_args(serve))
    want = [engine.transcribe([(audio_from_bytes(s), audio_from_bytes(e))])[0] for s, e in wavs]
    return got, want


def test_serve_answers_after_an_idle_spell_on_two_ranks(trained, tmp_path):
    """Two gloo ranks whose collectives time out after 3 s: rank 0 answers
    a request, stays idle for 5 s, then answers another; the follower's
    wait for the next batch does not run into the timeout, and both
    answers are one process's."""
    got, want = _serve_on_two_ranks(trained, tmp_path, timeout_s=3.0, idle_s=5.0)
    assert got == want and any(want)


def test_serve_without_a_mesh_on_two_ranks(trained, tmp_path):
    """``--data_parallel false`` under two ranks builds no mesh: rank 0
    serves alone and rank 1's ``follow`` returns at once."""
    got, want = _serve_on_two_ranks(trained, tmp_path, ("--data_parallel", "false"))
    assert got == want and any(want)


MEDIUM = os.path.join(REPO, "conf/tswhisper/train_tsasr_whisper_medium_lora_qkvo_r16_.yaml")
CONFLICTS = {  # name: (config, flags, the start of the JAX message)
    "draft-no-gamma": (CONFIG, ("--draft_path", "/x"),
                       "--draft_path requires --speculative_gamma > 0"),
    "draft-long-audio": (CONFIG, ("--draft_path", "/x", "--speculative_gamma", "2",
                                  "--long_audio", "true"),
                         "--draft_path is incompatible with --long_audio"),
    "timestamps-vocab": (CONFIG, ("--timestamps", "true"),
                         "--timestamps needs the full Whisper vocabulary"),
    "timestamps-speculative": (MEDIUM, ("--timestamps", "true", "--speculative_gamma", "2"),
                               "--timestamps is plain-greedy only"),
    "timestamps-ctc": (MEDIUM, ("--timestamps", "true", "--ctc_weight", "0.3"),
                       "--timestamps is plain-greedy only"),
    "ctc-speculative": (CONFIG, ("--ctc_weight", "0.3", "--speculative_gamma", "2"),
                        "--ctc_weight joint decoding is the single-device plain path"),
    "ctc-long-audio": (CONFIG, ("--ctc_weight", "0.3", "--long_audio", "true"),
                       "--ctc_weight joint decoding is the single-device plain path"),
}


def _jax_messages():
    """The messages of the JAX ``cli.decode``'s and ``cli.serve``'s
    ``parser.error`` calls, f-strings cut at their first field."""
    import ast
    import inspect

    from robustsq_whisper_tpu.cli import decode as jdecode
    from robustsq_whisper_tpu.cli import serve as jserve

    out = []
    for mod in (jdecode, jserve):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "error"
                    and node.args):
                arg = node.args[0]
                if isinstance(arg, ast.JoinedStr):
                    arg = arg.values[0]
                out.append(arg.value)
    return out


@pytest.mark.parametrize("name", list(CONFLICTS))
def test_flag_conflicts_stop_with_jax_messages(name, capsys):
    """The four flags this port serves stop on the combinations the JAX
    CLI refuses, before any weights are read, with the JAX message."""
    from robustsq_whisper_torch.cli import decode as pdecode

    config, flags, start = CONFLICTS[name]
    with pytest.raises(SystemExit) as e:
        pdecode.main(["--config", config, "--data_dir", "/nonexistent", "--output_dir",
                      "/nonexistent", "--device", "cpu", *flags])
    assert e.value.code == 2
    msg = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert msg.startswith(start)
    assert any(msg.startswith(m) for m in _jax_messages()), msg


def test_serve_draft_path_needs_gamma(capsys):
    from robustsq_whisper_torch.cli import serve as pserve

    with pytest.raises(SystemExit):
        pserve.parse_args(["--config", CONFIG, "--draft_path", "/x"])
    msg = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert msg == "--draft_path requires --speculative_gamma > 0" and msg in _jax_messages()


def test_cli_needs_cuda_unless_device_cpu(trained, monkeypatch, tmp_path):
    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.cli import serve as pserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdecode.main(_argv(trained, trained["pexp"], str(tmp_path / "o")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pserve.build_engine(pserve.parse_args(["--config", CONFIG]))
    assert not (tmp_path / "o").exists()

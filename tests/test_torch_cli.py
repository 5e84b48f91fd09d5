"""The port's ``cli.decode`` against the JAX package's on one checkpoint.

The JAX ``cli.train`` trains the dev smoke config on a ``cli.datapre
overlap`` data dir (12 epochs instead of the config's 1, so the greedy
transcripts are words rather than blanks); its checkpoint is read with the
JAX ``restore_weights``, mapped with ``convert.flax_to_state_dict`` and
saved with the port's ``save_checkpoint``. Then both CLIs decode the data
dir with the beam-1 inference yaml and the mini BPE ranks: the ``text``
files must be identical and every ``score.txt`` metric equal but the
real-time factor, greedy and speculative (with the same draft-acceptance
counters)."""

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


def _argv(t, expdir, out, *extra):
    return [
        "--config", t["config"], "--inference_config", BEAM1, "--data_dir", t["data_dir"],
        "--expdir", expdir, "--output_dir", out, "--batch_size", "4",
        "--tokenizer_assets", RANKS, *extra,
    ]


def _scores(out):
    with open(os.path.join(out, "score.txt")) as f:
        return dict(line.split() for line in f)


@pytest.mark.parametrize(
    "extra", [(), ("--speculative_gamma", "2", "--draft_layers", "1")],
    ids=["greedy", "speculative"],
)
def test_decode_equals_jax_cli(trained, extra):
    from robustsq_whisper_tpu.cli import decode as jdecode
    from robustsq_whisper_torch.cli import decode as pdecode

    t = trained
    jout, pout = (str(t["tmp"] / f"{k}_{len(extra)}") for k in ("jdec", "pdec"))
    assert jdecode.main(_argv(t, t["jexp"], jout, *extra)) == 0
    assert pdecode.main(_argv(t, t["pexp"], pout, "--device", "cpu", *extra)) == 0
    with open(os.path.join(jout, "text")) as f, open(os.path.join(pout, "text")) as g:
        jtext, ptext = f.read(), g.read()
    assert ptext == jtext
    hyps = kaldi_io.read_scp(os.path.join(pout, "text"))
    assert len(hyps) == 8 and any(h.strip() for h in hyps.values())
    js, ps = _scores(jout), _scores(pout)
    assert ps.pop("rtf") and js.pop("rtf")
    assert ps == js
    assert {"wer", "cer"} <= ps.keys()
    if extra:
        assert float(ps["spec_chunks"]) > 0


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


@pytest.mark.parametrize(
    "flag,value,item",
    [
        ("--model_parallel", "2", "A15"),
        ("--ctc_weight", "0.3", "A13"),
        ("--timestamps", "true", "A13"),
        ("--long_audio", "true", "A13"),
        ("--int8_weights", "true", "A10"),
        ("--enroll_type", "embedding", "A14"),
        ("--draft_path", "/nonexistent", "item 3"),
    ],
)
def test_unsupported_flags_stop(flag, value, item, capsys):
    from robustsq_whisper_torch.cli import decode as pdecode

    argv = ["--config", CONFIG, "--data_dir", "/nonexistent", "--output_dir", "/nonexistent",
            "--device", "cpu", flag, value]
    with pytest.raises(SystemExit) as e:
        pdecode.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "ROADMAP" in err and item in err


def test_serve_unsupported_flags_stop(capsys):
    from robustsq_whisper_torch.cli import serve as pserve

    for flag, value in (("--compile_cache", "/tmp/x"), ("--model_parallel", "2"),
                        ("--int8_weights", "true"), ("--draft_path", "/x")):
        with pytest.raises(SystemExit):
            pserve.parse_args(["--config", CONFIG, flag, value])
        assert flag in capsys.readouterr().err


def test_cli_needs_cuda_unless_device_cpu(trained, monkeypatch, tmp_path):
    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.cli import serve as pserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdecode.main(_argv(trained, trained["pexp"], str(tmp_path / "o")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pserve.build_engine(pserve.parse_args(["--config", CONFIG]))
    assert not (tmp_path / "o").exists()

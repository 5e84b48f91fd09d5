"""The port's training entry point (``train/loop.py``, ``train/eval.py``,
``cli/train.py``) against the JAX package's, on the CPU.

The data dirs are written here: speech WAVs and lazy ``*utt spk``
enrollment rows over a ``spk2enroll.json`` of two enrollments a speaker, so
both packages draw the same enrollments and crops. Every utterance targets
its own speaker and a batch holds two, so each row's ``neg_logits`` has
one valid column and the negative sampling is forced; SpecAugment and the
Qformer dropout are off (torch's random streams cannot reproduce
``jax.random``). Both loops start from the same weights (the JAX init
through ``convert.py``) and the same LoRA factors. Tolerances are the
three-step ones (``tests/test_torch_train.py``): stats to 1e-4 relative
(the gradient norm to 5e-4) with a 1e-6 floor, weights to 1e-5 absolute
(a tenth of one lr 1e-4 step) with Adam eps 1e-5; ``nbest.json`` must be
byte-identical."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from robustsq_whisper_torch.data import kaldi_io as pkio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, "conf/tswhisper/train_tsasr_whisper_dev_smoke.yaml")
BEAM1 = os.path.join(REPO, "conf/tswhisper/decode_asr_whisper_beam1.yaml")
RANKS = os.path.join(REPO, "tests/assets/mini_ranks.tiktoken")
WORDS = ("hello", "from", "the", "cat", "sat", "on", "mat", "speaker")


def write_dir(root, speakers, seed):
    """A Kaldi dir of one utterance per target speaker in ``speakers``."""
    rng = np.random.default_rng(seed)
    wav, text, utt2spk, enroll, pool = {}, {}, {}, {}, {}

    def audio(seconds, f0):
        t = np.arange(int(seconds * 16000)) / 16000
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(t.size)
        return x.astype(np.float32)

    for s in speakers:
        utt = f"{s}-0-0000_{s + 50}-0-0000_spk1"
        wav[utt] = os.path.join(root, "wavs", f"{utt}.wav")
        pkio.write_wav(wav[utt], audio(0.5 + 0.05 * (s % 5), 150 + 7 * s))
        text[utt] = " ".join(rng.choice(WORDS, 4))
        utt2spk[utt] = str(s)
        enroll[utt] = f"*{s}-0-0000 {s}"
        pool[str(s)] = []
        for k in (1, 2):
            p = os.path.join(root, "wavs", f"{s}-{k}-0000.wav")
            pkio.write_wav(p, audio(0.4 + 0.1 * k, 150 + 7 * s))
            pool[str(s)].append((f"{s}-{k}-0000", p))
    for name, rows in (("wav.scp", wav), ("text", text), ("utt2spk", utt2spk),
                       ("enroll.scp", enroll)):
        pkio.write_scp(os.path.join(root, name), rows)
    pkio.write_spk2enroll(os.path.join(root, "spk2enroll.json"), pool)
    return root


CONFIG = """whisper_model: dev
encoder_conf:
  num_query_tokens: 2
  num_hidden_layers: 1
  qformer_hidden_size: 64
  qformer_heads: 2
  qformer_intermediate_size: 128
  qformer_hidden_dropout: 0.0
  qformer_attention_dropout: 0.0
model_conf:
  vocab_size: 300
  sos: 257
  eos: 258
  startofprev: 259
  num_speakers: 8
  num_negatives: 2
  ctc_weight: 0.3
  use_specaug: false
train_conf:
  mode: {mode}
  lora:
    rank: 2
  optim:
    lr: 1.0e-4
    schedule: constant
    eps: 1.0e-5
decode_conf:
  max_new_tokens: 6
data_conf:
  speech_seconds: 0.64
  enroll_seconds: 0.32
  batch_size: 2
  num_epochs: 2
compute_dtype: float32
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These models are tiny: one intra-op thread runs their many small
    operations fastest, and keeps them from contending with the other test
    processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    out = {"train": write_dir(str(tmp / "train"), (100, 101, 102, 103), 0),
           "valid": write_dir(str(tmp / "valid"), (104, 105), 1), "tmp": tmp}
    for mode in ("full", "lora"):
        out[mode] = str(tmp / f"{mode}.yaml")
        with open(out[mode], "w") as f:
            f.write(CONFIG.replace("{mode}", mode))
    return out


class TokenIds:
    """The mini BPE ranks' ``encode``; ``decode`` writes the ids, so that
    hypotheses compare token for token."""

    def __init__(self, inner):
        self.inner = inner

    def encode(self, text):
        return self.inner.encode(text)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _datasets(pkg, exp, dirs, tokenizer=None):
    if pkg == "jax":
        from robustsq_whisper_tpu.data.dataset import KaldiTSDataset
        from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import load_tokenizer
    else:
        from robustsq_whisper_torch.data.dataset import KaldiTSDataset
        from robustsq_whisper_torch.tokenizer.whisper_tokenizer import load_tokenizer
    tok = tokenizer or TokenIds(load_tokenizer(RANKS))
    kw = dict(speech_seconds=exp.speech_seconds, enroll_seconds=exp.enroll_seconds,
              num_speakers=exp.model.num_speakers, seed=0)
    return KaldiTSDataset(dirs["train"], tok, **kw), KaldiTSDataset(dirs["valid"], tok, **kw)


def _jax_init(mode, dirs):
    """The JAX model, its initial variables and train state (its LoRA
    factors), as the JAX ``cli.train`` makes them."""
    import jax.numpy as jnp

    from robustsq_whisper_tpu.models import TSASRModel
    from robustsq_whisper_tpu.train.step import create_train_state
    from robustsq_whisper_tpu.utils.config import load_experiment

    exp = load_experiment(dirs[mode])
    model = TSASRModel(exp.resolved_dims(), exp.ts, exp.model, dtype=jnp.float32)
    first = next(_datasets("jax", exp, dirs)[0].batches(2, shuffle=False))
    first = {k: jnp.asarray(v) for k, v in first.items() if k != "utt_ids"}
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r: model.init(r, first, r, 0, train=False))(rng)
    state0, _ = create_train_state(rng, variables, exp.train)
    return exp, model, variables, state0, rng


def _port_model(mode, dirs, variables):
    from robustsq_whisper_torch.convert import load_flax
    from robustsq_whisper_torch.models import TSASRModel
    from robustsq_whisper_torch.utils.config import load_experiment

    exp = load_experiment(dirs[mode])
    return exp, load_flax(TSASRModel(exp.resolved_dims(), exp.ts, exp.model), variables)


def _loop_cfg(pkg, ckpt_dir, **kw):
    if pkg == "jax":
        from robustsq_whisper_tpu.train.loop import LoopConfig
    else:
        from robustsq_whisper_torch.train.loop import LoopConfig
    return LoopConfig(**{**dict(num_epochs=2, batch_size=2, log_every=1, ckpt_every_steps=0,
                                ckpt_dir=ckpt_dir, nbest=2), **kw})


def _close(got, want, rel, what):
    assert got == pytest.approx(want, rel=rel, abs=1e-6), what


LOOP_CASES = {  # mode: loop settings beyond two epochs of two steps
    "full": dict(ckpt_every_steps=1, keep_ckpts=1),  # mid-epoch saves, pruning
    "lora": dict(num_epochs=3, patience=1),  # early stop on no new best
}


@pytest.mark.parametrize("mode", list(LOOP_CASES))
def test_loop_equals_jax(dirs, mode):
    """Every logged stat, the validation stats, the final weights (and
    factors), the steps left on disk, ``nbest.json`` and the ``ave``
    weights."""
    from robustsq_whisper_tpu.train.checkpoint import restore_weights
    from robustsq_whisper_tpu.train.loop import run_training as jrun
    from robustsq_whisper_torch.convert import flax_lora_to_port, flax_to_state_dict
    from robustsq_whisper_torch.train.checkpoint import all_steps, read_payload
    from robustsq_whisper_torch.train.loop import run_training

    jexp, jmodel, variables, jstate0, rng = _jax_init(mode, dirs)
    # the port's copies first: the JAX step donates the weights' buffers
    exp, model = _port_model(mode, dirs, variables)
    lora = flax_lora_to_port(jstate0.lora) if mode == "lora" else None
    jtrain, jvalid = _datasets("jax", jexp, dirs)
    jdir, pdir = (str(dirs["tmp"] / f"{k}_{mode}") for k in ("jexp", "pexp"))
    jrec, prec = [], []
    loop = LOOP_CASES[mode]
    jstate = jrun(jmodel, jtrain, variables, jexp.train, _loop_cfg("jax", jdir, **loop), rng=rng,
                  metrics_hook=lambda s, v: jrec.append((s, v)), valid_dataset=jvalid)

    ptrain, pvalid = _datasets("torch", exp, dirs)
    state = run_training(model, ptrain, exp.train, _loop_cfg("torch", pdir, **loop),
                         metrics_hook=lambda s, v: prec.append((s, v)), valid_dataset=pvalid,
                         device="cpu", lora=lora)

    assert prec[-1][1].keys() == {f"seconds.{k}" for k in
                                  ("train", "valid", "valid_wer", "save", "restore", "average")}
    prec = prec[:-1]
    assert [s for s, _ in prec] == [s for s, _ in jrec]
    assert [s for s, _ in jrec][:6] == [1, 2, 2, 3, 4, 4]
    for (step, got), (_, want) in zip(prec, jrec):
        assert got.keys() == want.keys(), step
        for k, v in want.items():
            if k not in ("steps_per_sec", "epoch"):
                _close(got[k], float(v), 5e-4 if k == "grad_norm" else 1e-4, (step, k))
        assert got["epoch"] == want["epoch"]
    assert any(float(v["grad_norm"]) > 1.0 for _, v in jrec if "grad_norm" in v)  # clipping ran

    assert state.step == int(jstate.step) >= 4
    assert all_steps(pdir) == sorted(int(d) for d in os.listdir(jdir) if d.isdigit())
    ref = flax_to_state_dict({"params": jstate.params})
    frozen = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        frozen += not p.requires_grad
    assert (frozen > 0) == (mode == "lora")
    jl = flax_lora_to_port(jstate.lora)
    assert jl.keys() == state.lora.keys() and (len(jl) > 0) == (mode == "lora")
    for name, (a, b) in state.lora.items():
        np.testing.assert_allclose(a.detach().numpy(), jl[name][0].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(b.detach().numpy(), jl[name][1].numpy(), rtol=0, atol=1e-5)

    with open(os.path.join(jdir, "nbest.json"), "rb") as f, \
            open(os.path.join(pdir, "nbest.json"), "rb") as g:
        jbytes, pbytes = f.read(), g.read()
    assert pbytes == jbytes and len(json.loads(pbytes)["entries"]) == 2

    jparams, _, jlora, jstep, _ = restore_weights(os.path.join(jdir, "ave"))
    raw, pstep = read_payload(os.path.join(pdir, "ave"))
    assert pstep == 2 and raw["step"] == jstep  # the directory: 2 averaged; the last step
    ref = flax_to_state_dict({"params": jparams})
    assert raw["params"].keys() == ref.keys()
    for name, p in raw["params"].items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
    jl = flax_lora_to_port(jlora) if mode == "lora" else {}
    assert raw["lora"].keys() == jl.keys()
    for name, (a, b) in raw["lora"].items():
        np.testing.assert_allclose(a.numpy(), jl[name][0].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), jl[name][1].numpy(), rtol=0, atol=1e-5)


def _port_run(dirs, ckpt_dir, epochs, advance=0, **kw):
    """The port's loop from the seeded init over fresh datasets whose
    generators first run ``advance`` epochs (the draws a resumed run's
    datasets would have made before, in an uninterrupted run)."""
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.train.loop import run_training
    from robustsq_whisper_torch.utils.config import load_experiment

    exp = load_experiment(dirs["full"])
    train, valid = _datasets("torch", exp, dirs)
    for _ in range(advance):
        list(train.batches(2, shuffle=True))
        list(valid.batches(2, shuffle=False))
    lcfg = _loop_cfg("torch", ckpt_dir, num_epochs=epochs, **kw)
    rec = []
    state = run_training(build_model(exp, seed=0, device="cpu"), train, exp.train, lcfg,
                         metrics_hook=lambda s, v: rec.append((s, v)), valid_dataset=valid,
                         device="cpu")
    return state, [r for r in rec if not any(k.startswith("seconds.") for k in r[1])]


def test_resumed_run_equals_uninterrupted(dirs):
    """Three epochs in one run, and two epochs then a resume to three: the
    same stats, weights, optimizer state, ``nbest.json`` and ``ave``
    (exact: the same CPU operations on the same values)."""
    from robustsq_whisper_torch.train.checkpoint import read_payload

    one, two = (str(dirs["tmp"] / k) for k in ("one_run", "two_runs"))
    s1, rec1 = _port_run(dirs, one, 3, nbest=3)
    _, rec2a = _port_run(dirs, two, 2, nbest=3)
    s2, rec2b = _port_run(dirs, two, 3, advance=2, nbest=3)
    assert rec2b[0][0] == 5  # the resume continued at step 4, epoch 2

    def stats(rec):
        return [(s, {k: v for k, v in r.items() if k != "steps_per_sec"}) for s, r in rec]

    assert stats(rec1) == stats(rec2a + rec2b) and len(rec1) == 9  # 6 steps, 3 valid passes
    assert s1.step == s2.step == 6 and s1.opt.count == s2.opt.count == 6
    for (n, p), q in zip(s1.model.named_parameters(), s2.model.parameters()):
        assert torch.equal(p, q), n
    for a, b in zip(s1.opt.mu + s1.opt.nu, s2.opt.mu + s2.opt.nu):
        assert torch.equal(a, b)
    for d in ("", "ave"):
        (r1, st1), (r2, st2) = (read_payload(os.path.join(x, d)) for x in (one, two))
        assert st1 == st2
        for n, p in r1["params"].items():
            assert torch.equal(p, r2["params"][n]), (d, n)
    with open(os.path.join(one, "nbest.json"), "rb") as f, \
            open(os.path.join(two, "nbest.json"), "rb") as g:
        assert f.read() == g.read()


def test_resume_refuses_another_devices_generator(dirs):
    """A checkpoint's generator state restores onto a generator of the
    device type that saved it; a CUDA state (16 bytes of seed and offset)
    offered to a CPU generator stops the resume with that reason."""
    from robustsq_whisper_torch.train.checkpoint import STATE_FILE, latest_step

    ckpt = str(dirs["tmp"] / "generator")
    _port_run(dirs, ckpt, 1)
    path = os.path.join(ckpt, str(latest_step(ckpt)), STATE_FILE)
    raw = torch.load(path, weights_only=True)
    assert raw["generator"].numel() == torch.Generator().get_state().numel()
    raw["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(raw, path)
    with pytest.raises(RuntimeError, match="device type that saved it"):
        _port_run(dirs, ckpt, 2, advance=1)


def test_valid_wer_equals_jax_and_builds_once(dirs, monkeypatch):
    """``ValidWer`` on the same lora weights (factors made nonzero): the
    JAX ``ValidWer``'s hypotheses, token for token, and WER; the serving
    modules are built once over two calls; the training model keeps its
    mode, ``requires_grad`` flags and attached factors."""
    from robustsq_whisper_tpu.decode import pipeline as jpipe
    from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecode
    from robustsq_whisper_tpu.train.eval import ValidWer as JValidWer
    from robustsq_whisper_torch.convert import flax_lora_to_port
    from robustsq_whisper_torch.decode import pipeline as ppipe
    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.models.whisper.modules import Linear
    from robustsq_whisper_torch.train import create_train_state
    from robustsq_whisper_torch.train import eval as peval

    jexp, jmodel, variables, jstate, _ = _jax_init("lora", dirs)
    rng = np.random.default_rng(4)
    jstate = jstate.replace(lora={
        k: {"a": v["a"], "b": rng.standard_normal(np.shape(v["b"])).astype(np.float32) * 0.3}
        for k, v in jstate.lora.items()})
    _, jvalid = _datasets("jax", jexp, dirs)
    jhyps = {}
    real = jpipe.decode_dataset

    def capture(*a, **kw):
        res = real(*a, **kw)
        jhyps.update(res.hyps)
        return res

    monkeypatch.setattr(jpipe, "decode_dataset", capture)
    kw = dict(max_new_tokens=6, eot=258, init_tokens=(257,))
    jwer = JValidWer(jmodel, JDecode(**kw), n_utts=2)(jstate, jexp.train, jvalid, 2)

    exp, model = _port_model("lora", dirs, variables)
    state = create_train_state(model, exp.train, device="cpu", lora=flax_lora_to_port(jstate.lora))
    builds = {"enc": 0, "dec": 0}
    for name, key in (("QFormerTSEncoder", "enc"), ("TSDecoder", "dec")):
        cls = getattr(ppipe, name)

        class Counted(cls):
            def __init__(self, *a, _k=key, **k):
                builds[_k] += 1
                super().__init__(*a, **k)

        monkeypatch.setattr(ppipe, name, Counted)
    _, pvalid = _datasets("torch", exp, dirs)
    flags = {n: p.requires_grad for n, p in model.named_parameters()}
    attached = {n: m.lora for n, m in model.named_modules() if isinstance(m, Linear)}
    wer = peval.ValidWer(model, DecodeConfig(**kw), n_utts=2)
    got = wer(state, exp.train, pvalid, 2)
    assert wer.last_hyps == jhyps and len(jhyps) == 2 and all(jhyps.values())
    assert got == pytest.approx(jwer, abs=1e-12)
    assert wer(state, exp.train, pvalid, 2) == got
    assert builds == {"enc": 1, "dec": 1}
    assert model.training and flags == {n: p.requires_grad for n, p in model.named_parameters()}
    assert attached == {n: m.lora for n, m in model.named_modules() if isinstance(m, Linear)}
    assert sum(v is not None for v in attached.values()) == len(state.lora) > 0


def test_average_keeps_frozen_tensors_and_averages_masters(tmp_path):
    """A bf16 lora run: the ``ave`` checkpoint's frozen bf16 weights are the
    checkpoints' bit for bit; each trainable bf16 parameter is the bf16 cast
    of the float64 mean of its f32 masters, which the checkpoint holds too;
    the factors are their float64 mean in f32."""
    from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, WhisperDims
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.train import TrainConfig, create_train_state, make_train_step
    from robustsq_whisper_torch.train import eval as peval
    from robustsq_whisper_torch.train.checkpoint import read_payload, save_checkpoint
    from robustsq_whisper_torch.train.lora import LoraConfig
    from robustsq_whisper_torch.train.optim import OptimConfig

    dims = WhisperDims(n_audio_ctx=16, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
                       n_text_ctx=16, n_text_state=32, n_text_head=2, n_text_layer=1, n_vocab=50)
    ts = TSEncoderConfig(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
                         qformer_heads=2, qformer_intermediate_size=64)
    model = init_params(TSASRModel(dims, ts), 0).set_compute_dtype(torch.bfloat16)
    cfg = TrainConfig(mode="lora", lora=LoraConfig(rank=2),
                      optim=OptimConfig(lr=1e-2, schedule="constant"))
    state = create_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"speech": torch.randn(2, 3200, generator=g) * 0.1,
             "speech_lens": torch.tensor([3200, 3000]),
             "enroll": torch.randn(2, 1600, generator=g) * 0.1,
             "enroll_lens": torch.tensor([1600, 1600]),
             "text": torch.tensor([[5, 6, 7], [8, 9, -1]]), "text_lens": torch.tensor([3, 2]),
             "neg_logits": torch.tensor([[-1e4, 1.0], [1.0, -1e4]]),
             "spk_labels": torch.tensor([0, 1])}
    ckpt = str(tmp_path / "ckpt")
    for s in (1, 2, 3):
        step(state, batch, g, 0)
        save_checkpoint(ckpt, s, state, epoch=s, keep=None)
    tracker = peval.NBestTracker(ckpt, nbest=2)
    tracker.update(1, 0, 0.5)
    tracker.update(3, 2, 0.7)
    path = peval.write_averaged_checkpoint(ckpt, tracker)
    assert path.endswith(os.path.join("ave", "2"))
    ave, _ = read_payload(os.path.join(ckpt, "ave"))
    r1, r3 = read_payload(ckpt, 1)[0], read_payload(ckpt, 3)[0]
    names = r1["opt"]["names"]
    n_masters = 0
    for n, p in ave["params"].items():
        assert p.dtype == r1["params"][n].dtype, n
        if n in names and r1["opt"]["masters"][names.index(n)] is not None:
            i = names.index(n)
            m1, m3 = r1["opt"]["masters"][i], r3["opt"]["masters"][i]
            want = (m1.double() + (m3.double() - m1.double()) / 2).float()
            assert torch.equal(ave["opt"]["masters"][i], want), n
            assert torch.equal(p, want.bfloat16()), n
            n_masters += not torch.equal(m1, m3)
        elif n not in names:  # frozen: the same in every checkpoint, and in the mean
            assert torch.equal(r1["params"][n], r3["params"][n]), n
            assert torch.equal(p, r1["params"][n]), n
    assert n_masters > 0
    frozen = [n for n in ave["params"] if n not in names]
    assert sum(ave["params"][n].dtype == torch.bfloat16 for n in frozen) > 10
    for n, (a, b) in ave["lora"].items():
        for x, y, z in ((a, r1["lora"][n][0], r3["lora"][n][0]), (b, r1["lora"][n][1], r3["lora"][n][1])):
            assert torch.equal(x, (y.double() + (z.double() - y.double()) / 2).float()), n
    assert ave["step"] == r3["step"] and ave["epoch"] == 3


def test_cli_train_then_decode_use_ave(dirs, tmp_path):
    """``cli.train.main --device cpu`` on the dev smoke config with a valid
    dir (the valid WER on, n-best 2), then again with one more epoch, which
    resumes; then the port's ``cli.decode`` reads the ``ave`` checkpoint."""
    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.cli import train as ptrain
    from robustsq_whisper_torch.train.checkpoint import all_steps

    exp = str(tmp_path / "exp")
    argv = ["--config", DEV, "--train_dir", dirs["train"], "--valid_dir", dirs["valid"],
            "--expdir", exp, "--device", "cpu", "--batch_size", "2", "--nbest", "2",
            "--valid_wer_utts", "2", "--tokenizer_assets", RANKS, "--num_epochs", "2"]
    rec = []
    assert ptrain.main(argv, metrics_hook=lambda s, v: rec.append((s, v))) == 0
    valid = [v for _, v in rec if "valid.acc" in v]
    assert len(valid) == 2 and all({"valid.wer", "valid.cer", "valid.loss"} <= v.keys()
                                   for v in valid)
    ckpt = os.path.join(exp, "checkpoints")
    assert all_steps(ckpt) == [2, 4] and all_steps(os.path.join(ckpt, "ave")) == [2]
    rec.clear()
    assert ptrain.main(argv[:-1] + ["3"], metrics_hook=lambda s, v: rec.append((s, v))) == 0
    assert [s for s, v in rec if "valid.acc" in v] == [6] and all_steps(ckpt)[-1] == 6
    assert rec[-1][1]["seconds.restore"] > 0
    out = str(tmp_path / "decode")
    assert pdecode.main(["--config", DEV, "--inference_config", BEAM1, "--data_dir",
                         dirs["valid"], "--expdir", exp, "--output_dir", out, "--batch_size",
                         "2", "--tokenizer_assets", RANKS, "--device", "cpu"]) == 0
    hyps = pkio.read_scp(os.path.join(out, "text"))
    assert len(hyps) == 2
    with open(os.path.join(out, "score.txt")) as f:
        assert {"wer", "cer", "rtf"} <= {line.split()[0] for line in f}


@pytest.mark.parametrize("flag,value", [("--n_data", "2"), ("--n_model", "2"), ("--fsdp", "true")])
def test_mesh_flags_are_no_ops_on_one_device(dirs, tmp_path, flag, value, caplog):
    """One process makes no mesh, as the JAX CLI on one device: each flag
    is logged and the run trains as without it (the same checkpoint)."""
    import logging

    from robustsq_whisper_torch.cli import train as ptrain
    from robustsq_whisper_torch.train.checkpoint import read_payload

    argv = ["--config", DEV, "--train_dir", dirs["train"], "--device", "cpu",
            "--batch_size", "2", "--tokenizer_assets", RANKS, "--num_epochs", "1"]
    caplog.set_level(logging.INFO)
    assert ptrain.main(argv + ["--expdir", str(tmp_path / "a"), flag, value]) == 0
    assert "one device: --n_data, --n_model and fsdp make no mesh" in caplog.text
    assert ptrain.main(argv + ["--expdir", str(tmp_path / "b")]) == 0
    a, _ = read_payload(str(tmp_path / "a" / "checkpoints"))
    b, _ = read_payload(str(tmp_path / "b" / "checkpoints"))
    for name, p in b["params"].items():
        assert torch.equal(a["params"][name], p), name


def test_cli_train_raises_without_cuda(dirs, tmp_path, monkeypatch):
    """The entry point defaults to the card and never falls back to the
    CPU."""
    from robustsq_whisper_torch.cli import train as ptrain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.main(["--config", DEV, "--train_dir", dirs["train"], "--expdir",
                     str(tmp_path / "exp")])

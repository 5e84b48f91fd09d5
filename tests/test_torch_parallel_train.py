"""Multi-GPU training of the port against the JAX package's single-device
step, on the CPU.

The port's data-parallel x tensor-parallel (2 x 2), fully sharded (4 data
ranks), sequence-parallel (2 x 2) and LoRA-under-tensor-parallel (2 x 2)
steps run in gloo worker processes (``tests/_torch_dist.py``) on the tiny
training model of ``test_torch_train.py`` (its flash route: 2 + 256
encoder positions, split 129 a rank under sequence parallelism; the
decoder's 1 + 2 + 7 positions split too), one global batch of 4 handed to
every rank. JAX's bars (``tests/test_train_step.py``): the loss to 1e-4
relative and the gradient norm to 1e-3, every step. After three steps
every parameter (and LoRA factor) is held to ``test_torch_train.py``'s
1e-5 absolute (a tenth of one lr 1e-4 Adam step) against the port's own
single-device steps, and to JAX's single-device steps within
``JAX_ATOL``, 3e-5: on this batch the single-device port and JAX already
differ by 1.55e-5 in one element of block 0's ``attn.out`` weight. That
element's first clipped gradient nearly cancels (-1.6e-6 in the port,
-3.9e-6 in JAX, against a median of 2e-3 over its tensor; the difference
is inside ``test_ts_model_loss_and_grads_match_jax``'s gradient bar), and
Adam's first update, lr g / (|g| + eps) with eps 1e-5, maps it to
1.41e-5 against 2.83e-5; the later gradients there are 100 times larger
and agree, so the gap stays. As there, SpecAugment is off,
the Qformer's dropout is 0 and every row has one valid negative, since
torch's streams cannot reproduce ``jax.random``; with them on, two seeded
steps on 4 data ranks are held to the port's own single-device steps. A
2-rank fully sharded ``run_training`` writes the checkpoint one device
writes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from robustsq_whisper_tpu.train import lora as jlora
from robustsq_whisper_tpu.train import optim as joptim
from robustsq_whisper_tpu.train import step as jstep
from robustsq_whisper_torch.convert import flax_lora_to_port, flax_to_state_dict

from robustsq_whisper_torch.train import lora as tlora
from robustsq_whisper_torch.train import optim as toptim
from robustsq_whisper_torch.train import step as tstep

from ._torch_dist import launch
from .test_torch_train import CFG, DIMS, SAMPLES, E_SAMPLES, TS, _jbatch, _port_model, _tbatch

B = 4
# the sharded weights against JAX's after three steps: twice the
# single-device port's gap on this batch (1.55e-5, see above)
JAX_ATOL = 3e-5
OPTIM = dict(lr=1e-4, schedule="constant", eps=1e-5)
# SpecAugment and the Qformer's dropouts on
RANDOM_TS = dict(qformer_hidden_dropout=0.1, qformer_attention_dropout=0.1)
RANDOM_CFG = dict(use_specaug=True)


def _batch4(seed=2):
    rng = np.random.default_rng(seed)
    neg = np.full((B, B), -10000.0, np.float32)
    neg[np.arange(B), (np.arange(B) + 1) % B] = 1.0
    text = rng.integers(4, 60, (B, 6)).astype(np.int32)
    text_lens = np.array([6, 4, 5, 6], np.int32)
    text[np.arange(6)[None] >= text_lens[:, None]] = -1
    return {
        "speech": (rng.standard_normal((B, SAMPLES)) * 0.05).astype(np.float32),
        "speech_lens": np.array([SAMPLES, SAMPLES - 9000, SAMPLES - 30000, SAMPLES - 500],
                                np.int32),
        "enroll": (rng.standard_normal((B, E_SAMPLES)) * 0.05).astype(np.float32),
        "enroll_lens": np.array([E_SAMPLES, E_SAMPLES - 5000, E_SAMPLES, E_SAMPLES - 900],
                                np.int32),
        "text": text,
        "text_lens": text_lens,
        "neg_logits": neg,
        "spk_labels": rng.integers(0, 8, (B,)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's single-device three steps' stats and weights and the port's
    single-device weights after them, full and lora, and the port's gloo
    runs of every sharded case."""
    from robustsq_whisper_tpu.models import TSASRModel as JModel
    from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
    from robustsq_whisper_tpu.models import TSModelConfig as JCfg
    from robustsq_whisper_tpu.models import WhisperDims as JDims

    jmodel = JModel(JDims(**DIMS), JTS(**TS), JCfg(**CFG))
    batch = _batch4()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jmodel.init(k, _jbatch(batch), k, 0, train=False))(key)
    ref = {}
    for mode in ("full", "lora"):
        jcfg = jstep.TrainConfig(mode=mode, optim=joptim.OptimConfig(**OPTIM),
                                 lora=jlora.LoraConfig(rank=2))
        jstate, tx = jstep.create_train_state(jax.random.PRNGKey(3), variables, jcfg)
        lora0 = flax_lora_to_port(jstate.lora) if mode == "lora" else None
        jfn = jstep.make_train_step(jmodel, tx, jcfg, donate=False)
        stats = []
        for i in range(3):
            jstate, jst = jfn(jstate, _jbatch(batch), jax.random.PRNGKey(i), 6)
            stats.append({k: float(v) for k, v in jst.items()})
        model = _port_model(variables)
        tcfg = tstep.TrainConfig(mode=mode, optim=toptim.OptimConfig(**OPTIM),
                                 lora=tlora.LoraConfig(rank=2))
        state = tstep.create_train_state(model, tcfg, device="cpu", lora=lora0)
        fn = tstep.make_train_step(model, tcfg, device="cpu")
        for _ in range(3):
            state, _ = fn(state, _tbatch(batch), None, 6)
        ref[mode] = dict(stats=stats, lora0=lora0,
                         jax_params=flax_to_state_dict({"params": jstate.params}),
                         jax_lora=flax_lora_to_port(jstate.lora) if mode == "lora" else {},
                         params={n: p.detach().clone() for n, p in model.named_parameters()},
                         lora={n: (a.detach(), b.detach()) for n, (a, b) in state.lora.items()})
    # the port alone, with its random draws on (generator seeded 0, as the
    # workers')
    model = _port_model(variables, **RANDOM_TS)
    model.cfg = dataclasses.replace(model.cfg, **RANDOM_CFG)
    tcfg = tstep.TrainConfig(optim=toptim.OptimConfig(**OPTIM))
    state = tstep.create_train_state(model, tcfg, device="cpu")
    fn = tstep.make_train_step(model, tcfg, device="cpu")
    gen, stats = torch.Generator().manual_seed(0), []
    for _ in range(2):
        state, st = fn(state, _tbatch(batch), gen, 6)
        stats.append({k: float(v) for k, v in st.items()})
    ref["random"] = dict(stats=stats,
                         params={n: p.detach().clone() for n, p in model.named_parameters()})
    workdir = tmp_path_factory.mktemp("train")
    torch.save({
        "dims": DIMS, "ts": TS, "cfg": CFG, "optim": OPTIM, "batch": batch,
        "state_dict": flax_to_state_dict(variables), "lora": ref["lora"]["lora0"],
        "cases": [
            ("dp-tp", (2, 2), {}, {}, {}, 3),
            ("fsdp", (4, 1), dict(fsdp=True), {}, {}, 3),
            ("dp-tp-sp", (2, 2), {}, dict(sequence_parallel=True), {}, 3),
            ("lora-tp", (2, 2), dict(mode="lora"), {}, {}, 3),
            ("dp-random", (4, 1), {}, RANDOM_TS, RANDOM_CFG, 2),
        ],
    }, workdir / "inputs.pt")
    launch("train", 4, str(workdir), timeout=300)
    outs = [torch.load(workdir / f"out-{r}.pt", weights_only=False) for r in range(4)]
    return ref, outs


@pytest.mark.parametrize("case,mode", [("dp-tp", "full"), ("fsdp", "full"),
                                       ("dp-tp-sp", "full"), ("lora-tp", "lora")])
def test_sharded_steps_equal_jax(jax_runs, case, mode):
    ref, outs = jax_runs
    r = ref[mode]
    for rank, out in enumerate(outs):
        got = out[case]
        for i, (st, jst) in enumerate(zip(got["stats"], r["stats"])):
            assert set(st) == set(jst)
            assert st["loss"] == pytest.approx(jst["loss"], rel=1e-4), (rank, i)
            assert st["grad_norm"] == pytest.approx(jst["grad_norm"], rel=1e-3), (rank, i)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), r["params"][name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{case} rank {rank} {name}")
            np.testing.assert_allclose(p.numpy(), r["jax_params"][name].numpy(), rtol=0,
                                       atol=JAX_ATOL, err_msg=f"{case} rank {rank} {name} jax")
        assert set(got["lora"]) == set(r["jax_lora"])
        for name, (a, b) in got["lora"].items():
            for t, want, jwant in zip((a, b), r["lora"][name], r["jax_lora"][name]):
                np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=0, atol=1e-5)
                np.testing.assert_allclose(t.numpy(), jwant.numpy(), rtol=0, atol=JAX_ATOL)
    if case != "fsdp":
        assert outs[0][case]["tp"] and not outs[0][case]["fsdp"]
    if mode == "lora":
        assert len(outs[0][case]["lora"]) > 0


def test_fsdp_ranks_store_a_quarter(jax_runs):
    """Each of the 4 data ranks holds 1/4 of every fully sharded parameter
    and of its f32 master and Adam moments; the rest stay whole."""
    ref, outs = jax_runs
    full = ref["full"]["params"]
    sharded = set(outs[0]["fsdp"]["fsdp"])
    assert len(sharded) > 10
    for out in outs:
        for name, sizes in out["fsdp"]["stored"].items():
            n = full[name].numel()
            want = n // 4 if name in sharded else n
            assert sizes == (want, want, want, want), (name, sizes, n)


def test_random_draws_cover_the_whole_batch(jax_runs):
    """SpecAugment, the Qformer's dropouts and the negative sampling draw
    for the whole batch on every data rank (each keeps its rows), so two
    seeded steps on 4 ranks equal one device's: f32 sums in another order,
    the stats to 1e-5 relative, the weights to 1e-5 absolute, the gradient
    norm to 1e-4 (it is the CTC gradient's, whose alpha-beta posteriors
    over 256 frames move by some 1e-5 relative when the rows' sums change
    order: 3.2e-5 measured)."""
    ref, outs = jax_runs
    want = ref["random"]
    for out in outs:
        got = out["dp-random"]
        for st, wst in zip(got["stats"], want["stats"]):
            for k, v in wst.items():
                rel = 1e-4 if k == "grad_norm" else 1e-5
                assert st[k] == pytest.approx(v, rel=rel, abs=1e-6), k
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
    # the draws did something: the masked loss differs from the unmasked one
    assert want["stats"][0]["loss"] != pytest.approx(ref["full"]["stats"][0]["loss"], rel=1e-3)


def test_fsdp_run_training_checkpoint_is_one_devices(tmp_path):
    """``run_training`` of the dev smoke model, 2 epochs on 2 fully sharded
    data ranks, saves the checkpoints one device saves (every parameter,
    master and moment whole, the same step, epoch and generator state):
    held to a single-device run to 1e-4 absolute, a tenth of one Adam step
    at the dev config's lr 1e-3 (the bar ``test_torch_train.py`` derives
    for lr 1e-4), and restored onto one device."""
    from robustsq_whisper_torch.train.checkpoint import latest_step, read_payload, restore_checkpoint
    from robustsq_whisper_torch.train.step import create_train_state
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.utils.config import load_experiment

    from ._torch_dist import _dev_run
    from .test_torch_train_cli import DEV, RANKS, write_dir

    train_dir = write_dir(str(tmp_path / "train"), (100, 101, 102, 103), 0)
    inp = dict(config=DEV, ranks=RANKS, train_dir=train_dir, epochs=2)
    torch.save(dict(inp, ckpt_dir=str(tmp_path / "sharded")), tmp_path / "inputs.pt")
    launch("run_training", 2, str(tmp_path), timeout=180)
    out = torch.load(tmp_path / "out-0.pt", weights_only=False)
    assert len(out["fsdp"]) > 20 and out["step"] == 4
    torch.manual_seed(0)
    _dev_run(dict(inp, ckpt_dir=str(tmp_path / "one")))
    assert latest_step(str(tmp_path / "sharded")) == latest_step(str(tmp_path / "one")) == 4
    got, _ = read_payload(str(tmp_path / "sharded"))
    want, _ = read_payload(str(tmp_path / "one"))
    assert got.keys() == want.keys() and got["params"].keys() == want["params"].keys()
    assert (got["step"], got["epoch"]) == (want["step"], want["epoch"])
    assert torch.equal(got["generator"], want["generator"])
    for name, p in want["params"].items():
        assert got["params"][name].shape == p.shape
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert got["opt"]["names"] == want["opt"]["names"]
    # the moments to 1e-4 of each tensor's largest entry, with a floor of
    # 1e-9 for the gradients that are zero in exact arithmetic (the
    # attention key biases: both sides hold f32 noise of some 1e-11 there)
    for key in ("mu", "nu"):
        for g, w in zip(got["opt"][key], want["opt"][key]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                       atol=1e-4 * float(w.abs().max()) + 1e-9)
    exp = load_experiment(DEV)
    state = create_train_state(build_model(exp, 0, "cpu"), exp.train, device="cpu")
    state, epoch, _ = restore_checkpoint(str(tmp_path / "sharded"), state)
    assert (state.step, epoch) == (4, 2)
    for name, p in state.model.named_parameters():
        assert torch.equal(p, got["params"][name]), name

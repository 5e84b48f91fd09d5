"""The port's draft distillation against the JAX package's on the CPU.

A tiny teacher decoder (flax-initialised, bridged with
``convert.load_flax``) and the same seeded memory, speaker prompt and
teacher-forcing rows go through both packages' ``distill_draft`` in f32:
each step's batch loss and agreement (JAX's read through a
``jax.debug.callback`` on its ``value_and_grad``), the final weights and
the whole-corpus agreement must agree to 1e-5. Both draw their batches
from ``numpy.random.default_rng(seed)``, so they train on the same rows.
Then the draft's save / load round trip is exact, and speculative decode
with the loaded draft gives the target's greedy tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.train import distill as jdistill
from robustsq_whisper_torch.convert import flax_to_state_dict, load_flax
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder
from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
from robustsq_whisper_torch.models import TSDecoder, WhisperDims
from robustsq_whisper_torch.train import distill as pdistill

DIMS = dict(n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=64, n_audio_head=2,
            n_audio_layer=1, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=3)
SOP, SOT, EOT = 3, 1, 2
STEPS, LR, BATCH, SEED = 5, 3e-3, 4, 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_teacher_forcing_inputs_equal_jax():
    rng = np.random.default_rng(0)
    text = rng.integers(4, 60, (5, 7)).astype(np.int32)
    lens = np.array([7, 3, 0, 5, 1], np.int32)
    text[np.arange(7)[None, :] >= lens[:, None]] = -1
    for got, want in zip(pdistill.teacher_forcing_inputs(text, lens, SOT, EOT),
                         jdistill.teacher_forcing_inputs(text, lens, SOT, EOT)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_warmup_cosine_schedule_equals_optax():
    """``optim.make_schedule``'s ``warmup_cosine``, as ``distill_draft``
    configures it, against optax's."""
    import optax

    from robustsq_whisper_torch.train.optim import OptimConfig, make_schedule

    for steps in (3, 8, 40, 400):
        warm = min(50, steps // 4)
        want = optax.warmup_cosine_decay_schedule(0.0, LR, warm, steps)
        got = make_schedule(OptimConfig(lr=LR, schedule="warmup_cosine", warmup_steps=warm,
                                        total_steps=steps))
        for n in range(steps + 2):
            np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-10)


class _RecordingJax:
    """``jax`` for the JAX distillation module, with ``value_and_grad``
    reporting every step's (loss, agreement) through a debug callback."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jax, name)

    def value_and_grad(self, fn, **kw):
        inner = jax.value_and_grad(fn, **kw)

        def wrapped(*args):
            (loss, agree), grads = inner(*args)
            jax.debug.callback(lambda l, a: self.seen.append((float(l), float(a))), loss, agree)
            return (loss, agree), grads

        return wrapped


@pytest.fixture(scope="module")
def distilled():
    """Both packages' drafts of one teacher, their stats and step logs."""
    rng = np.random.default_rng(1)
    n, length = 6, 8
    memory = rng.standard_normal((n, 10, 64)).astype(np.float32)
    prompt = rng.standard_normal((n, 2, 64)).astype(np.float32)
    lens = rng.integers(2, length + 1, n).astype(np.int32)
    text = rng.integers(4, 60, (n, length)).astype(np.int32)
    text[np.arange(length)[None, :] >= lens[:, None]] = -1
    ys_in, mask = jdistill.teacher_forcing_inputs(text, lens, SOT, EOT)
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, flat_self_cache=False)
    variables = jax.jit(jd.init)(jax.random.PRNGKey(2), jnp.asarray(memory),
                                 jnp.zeros((n, 4), jnp.int32), jnp.asarray(prompt))
    td = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP,
                             flat_self_cache=False), variables)
    kw = dict(steps=STEPS, lr=LR, batch_size=BATCH, seed=SEED)
    j_seen, j_log = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jdistill, "jax", _RecordingJax(j_seen))
    try:
        j_vars, j_stats = jdistill.distill_draft(
            jd, variables, 1, jnp.asarray(memory), jnp.asarray(prompt), ys_in, mask,
            log=j_log.append, **kw)
        jax.effects_barrier()
    finally:
        mp.undo()
    p_seen, p_log = [], []
    draft, p_stats = pdistill.distill_draft(
        td, 1, torch.from_numpy(memory), torch.from_numpy(prompt), ys_in, mask,
        log=p_log.append, on_step=lambda s, l, a: p_seen.append((l, a)), **kw)
    return dict(td=td, memory=memory, prompt=prompt, j=(j_vars, j_stats, j_seen, j_log),
                p=(draft, p_stats, p_seen, p_log))


def test_distill_draft_equals_jax(distilled):
    j_vars, j_stats, j_seen, j_log = distilled["j"]
    draft, p_stats, p_seen, p_log = distilled["p"]
    assert len(j_seen) == len(p_seen) == STEPS
    np.testing.assert_allclose(np.array(p_seen), np.array(j_seen), rtol=1e-5, atol=1e-5)
    assert p_log == j_log and len(p_log) == 2  # steps 0 and the last
    assert p_seen[-1][0] < p_seen[0][0]  # it learns
    assert p_stats["steps"] == j_stats["steps"] == STEPS
    for key in ("final_loss", "final_agreement"):
        assert abs(p_stats[key] - j_stats[key]) <= 1e-5, (key, p_stats, j_stats)
    want = flax_to_state_dict(j_vars)
    got = draft.state_dict()
    assert got.keys() == want.keys() and len(draft.decoder.blocks) == 1
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-5, msg=k)
    teacher = distilled["td"].state_dict()
    assert torch.equal(got["decoder.token_embedding.weight"],
                       teacher["decoder.token_embedding.weight"])  # frozen
    assert not torch.equal(got["decoder.blocks.0.mlp_fc1.weight"],
                           teacher["decoder.blocks.0.mlp_fc1.weight"])  # trained
    assert not any(p.requires_grad for p in draft.parameters())


def test_save_load_round_trip_and_speculative_decode(distilled, tmp_path):
    """The saved draft and meta come back exactly; the loaded draft, built
    like the target, drives speculative decode to the target's greedy
    tokens (and some of its proposals are accepted)."""
    draft, stats = distilled["p"][:2]
    meta = {"draft_layers": 1, "teacher_step": 3, "teacher_ckpt": "x",
            "final_agreement": stats["final_agreement"], "final_loss": stats["final_loss"],
            "steps": STEPS, "corpus_items": 6}
    path = pdistill.save_draft(str(tmp_path / "draft"), draft, meta)
    sd, meta2 = pdistill.load_draft(path)
    assert meta2 == meta
    own = draft.state_dict()
    assert sd.keys() == own.keys() and all(torch.equal(sd[k], own[k]) for k in sd)
    with pytest.raises(FileNotFoundError):
        pdistill.load_draft(str(tmp_path / "none"))
    td = distilled["td"]
    loaded = pdistill.build_draft(td, sd, torch.float32)
    cfg = DecodeConfig(max_new_tokens=8, eot=EOT, init_tokens=(SOT,), quantize_cross_kv=True,
                       speculative_gamma=3, draft_layers=1)
    mem, prm = torch.from_numpy(distilled["memory"]), torch.from_numpy(distilled["prompt"])
    tokens, _, st = build_speculative_decoder(td, cfg, device="cpu", return_stats=True,
                                              draft=loaded)(mem, prm)
    greedy, _ = build_beam_decoder(td, dataclasses.replace(cfg, speculative_gamma=0),
                                   device="cpu")(mem, prm)
    assert torch.equal(tokens, greedy)
    assert st["accepted"].sum() > 0

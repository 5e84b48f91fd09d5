"""The port's training slice against the JAX package's, on the CPU.

Losses, the optimizer, the whole ``TSASRModel`` loss with every parameter
gradient, and three ``make_train_step`` steps in each mode. The JAX model
runs its flash-attention kernels in Pallas interpret mode (the encoder
self-attention has 2 + 256 positions, so the flash gate fires), the port
the kernels' plain versions behind the same ``torch.autograd.Function``
that launches them on the card. Everything is f32.

torch's random streams cannot reproduce ``jax.random``, so the parity
tests switch SpecAugment off, set the Qformer dropout rates to 0 and make
the negative sampling deterministic (``neg_logits`` has one valid column
per row, -10000 elsewhere, which both samplers pick with probability 1);
the stochastic parts are tested by their properties. Each tolerance is
stated where it is used.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.losses import asr as jasr
from robustsq_whisper_tpu.losses import speaker as jspk
from robustsq_whisper_tpu.models import TSASRModel as JModel
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import TSModelConfig as JCfg
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.train import lora as jlora
from robustsq_whisper_tpu.train import optim as joptim
from robustsq_whisper_tpu.train import step as jstep
from robustsq_whisper_torch.convert import flax_lora_to_port, flax_to_state_dict, load_flax
from robustsq_whisper_torch.losses import asr as tasr
from robustsq_whisper_torch.losses import speaker as tspk
from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig, WhisperDims
from robustsq_whisper_torch.train import lora as tlora
from robustsq_whisper_torch.train import optim as toptim
from robustsq_whisper_torch.train import step as tstep

# small dims on the flash route: 512 mel frames -> 256 encoder positions
DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=256, n_audio_state=64,
    n_audio_head=2, n_audio_layer=2, n_text_ctx=32, n_text_state=64,
    n_text_head=2, n_text_layer=2,
)
TS = dict(
    num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
    qformer_heads=2, qformer_intermediate_size=64, use_flash_attention=True,
    qformer_hidden_dropout=0.0, qformer_attention_dropout=0.0,
)
CFG = dict(
    vocab_size=64, sos=1, eos=2, startofprev=3, num_speakers=8,
    num_negatives=2, use_specaug=False,
)
B, SAMPLES, E_SAMPLES = 3, 512 * 160, 200 * 160


def _np(x):
    return np.asarray(x, np.float32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    # one valid negative per row (the next row), so sampling is deterministic
    neg = np.full((B, B), -10000.0, np.float32)
    neg[np.arange(B), (np.arange(B) + 1) % B] = 1.0
    text = rng.integers(4, 60, (B, 6)).astype(np.int32)
    text_lens = np.array([6, 4, 5], np.int32)
    text[np.arange(6)[None] >= text_lens[:, None]] = -1
    return {
        "speech": (rng.standard_normal((B, SAMPLES)) * 0.05).astype(np.float32),
        "speech_lens": np.array([SAMPLES, SAMPLES - 9000, SAMPLES - 30000], np.int32),
        "enroll": (rng.standard_normal((B, E_SAMPLES)) * 0.05).astype(np.float32),
        "enroll_lens": np.array([E_SAMPLES, E_SAMPLES - 5000, E_SAMPLES], np.int32),
        "text": text,
        "text_lens": text_lens,
        "neg_logits": neg,
        "spk_labels": rng.integers(0, 8, (B,)).astype(np.int32),
    }


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    jmodel = JModel(JDims(**DIMS), JTS(**TS), JCfg(**CFG))
    tiny = _jbatch(_batch())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jmodel.init(k, tiny, k, 0, train=False))(key)
    return jmodel, variables


def _port_model(variables, **ts):
    model = TSASRModel(
        WhisperDims(**DIMS), TSEncoderConfig(**{**TS, **ts}), TSModelConfig(**CFG)
    )
    return load_flax(model, variables)


# ---- losses ----


def test_add_sos_eos_matches_jax():
    ys = np.array([[5, 6, 7, -1], [8, -1, -1, -1], [9, 10, 11, 12]], np.int32)
    lens = np.array([3, 1, 4], np.int32)
    ref = jasr.add_sos_eos(jnp.asarray(ys), jnp.asarray(lens), 1, 2, pad_in=2)
    got = tasr.add_sos_eos(torch.from_numpy(ys), torch.from_numpy(lens), 1, 2, pad_in=2)
    for g, r in zip(got, ref):  # integers: exact
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("smoothing,normalize", [(0.0, False), (0.1, False), (0.1, True)])
def test_label_smoothing_and_accuracy_match_jax(smoothing, normalize):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    targets = rng.integers(0, 40, (3, 5)).astype(np.int32)
    targets[1, 3:] = -1
    targets[0, 0] = logits[0, 0].argmax()  # at least one right
    ref = jasr.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(targets), smoothing, normalize_length=normalize)
    got = tasr.label_smoothing_loss(torch.from_numpy(logits), torch.from_numpy(targets), smoothing, normalize_length=normalize)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)  # f32 sums
    acc_ref = jasr.token_accuracy(jnp.asarray(logits), jnp.asarray(targets))
    acc = tasr.token_accuracy(torch.from_numpy(logits), torch.from_numpy(targets))
    assert acc.item() == pytest.approx(float(acc_ref), abs=1e-7) and acc.item() > 0


def test_ctc_matches_optax():
    """Loss and the head's gradients; T >= L with room (optax gives a large
    finite loss where F.ctc_loss gives inf for an impossible alignment)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 20, 16)).astype(np.float32)
    lens = np.array([20, 15, 11], np.int32)
    labels = rng.integers(1, 30, (3, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 4], np.int32)
    labels[np.arange(5)[None] >= label_lens[:, None]] = -1
    jhead = jasr.CTCHead(30)
    args = tuple(map(jnp.asarray, (x, lens, labels, label_lens)))
    v = jhead.init(jax.random.PRNGKey(0), *args)
    loss_ref, g_ref = jax.value_and_grad(lambda v: jhead.apply(v, *args))(v)
    head = tasr.CTCHead(30, 16)
    load_flax(head, v)
    loss = head(*(torch.from_numpy(a) for a in (x, lens, labels, label_lens)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)  # f32 forward-backward sums
    ref = flax_to_state_dict(g_ref)
    for name, p in head.named_parameters():  # O(1) grads; f32 alpha-beta sums in another order
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_asp_matches_jax(with_lengths):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, 16)).astype(np.float32)
    lens = np.array([12, 7, 9], np.int32) if with_lengths else None
    jasp = jspk.AttentiveStatisticsPooling(16)
    j_args = (jnp.asarray(x), 3.5, None if lens is None else jnp.asarray(lens))
    v = jasp.init(jax.random.PRNGKey(1), *j_args)
    ref = jasp.apply(v, *j_args)
    asp = load_flax(tspk.AttentiveStatisticsPooling(16), v)
    got = asp(torch.from_numpy(x), 3.5, None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=1e-5, atol=1e-6)  # f32


def test_arc_infonce_with_given_negatives_matches_jax():
    rng = np.random.default_rng(4)
    prompt = rng.standard_normal((4, 3, 16)).astype(np.float32)
    enr = rng.standard_normal((4, 16)).astype(np.float32)
    enr /= np.linalg.norm(enr, axis=-1, keepdims=True)
    neg = np.full((4, 4), -10000.0, np.float32)
    neg[np.arange(4), [2, 3, 0, 1]] = 1.0  # one valid column a row
    ref = jspk.arc_infonce_loss(jnp.asarray(prompt), jnp.asarray(enr), jnp.asarray(neg), jax.random.PRNGKey(0), num_negatives=3)
    got = tspk.arc_infonce_loss(torch.from_numpy(prompt), torch.from_numpy(enr), torch.from_numpy(neg), torch.Generator().manual_seed(0), num_negatives=3)
    np.testing.assert_allclose(got[0].item(), float(ref[0]), rtol=1e-5)  # f32 through arccos/cos
    assert got[1].item() == pytest.approx(float(ref[1]))


@pytest.mark.parametrize("margin", [0.0, 0.25])
def test_aam_matches_jax(margin):
    rng = np.random.default_rng(5)
    pooled = rng.standard_normal((4, 16)).astype(np.float32)
    labels = np.array([0, 3, 5, 3], np.int32)
    jaam = jspk.AAMSoftmaxHead(6, 16)
    v = jaam.init(jax.random.PRNGKey(2), jnp.asarray(pooled), jnp.asarray(labels), margin)
    ref = jaam.apply(v, jnp.asarray(pooled), jnp.asarray(labels), margin)
    aam = load_flax(tspk.AAMSoftmaxHead(6, 16), v)
    got = aam(torch.from_numpy(pooled), torch.from_numpy(labels), margin)
    np.testing.assert_allclose(got[0].item(), float(ref[0]), rtol=1e-5)  # f32
    assert got[1].item() == pytest.approx(float(ref[1]))


def test_schedules_match_jax():
    for epoch in (0, 1, 3, 5, 6, 9):
        assert tspk.asp_gamma_schedule(epoch) == pytest.approx(float(jspk.asp_gamma_schedule(epoch)), rel=1e-6)
        assert tspk.aam_margin_schedule(epoch) == pytest.approx(float(jspk.aam_margin_schedule(epoch)))


def test_negative_sampling_follows_the_mask():
    """multinomial with replacement never picks a same-speaker column."""
    neg = torch.where(torch.eye(4) > 0, -10000.0, 1.0)
    idx = tspk.sample_negatives(neg, 50, torch.Generator().manual_seed(1))
    assert idx.shape == (50, 4)
    assert not (idx == torch.arange(4)[None]).any()
    assert len(set(idx[:, 0].tolist())) == 3  # every other row drawn


# ---- optimizer ----


OPTIM_CASES = {
    "warmuplr, clipped": (dict(lr=1e-2, warmup_steps=3, clip_norm=0.5), 1),
    "constant, bf16 first moment": (dict(lr=1e-2, schedule="constant", moment_dtype="bfloat16"), 1),
    "linear, weight decay": (dict(lr=1e-2, schedule="linear", warmup_steps=4, weight_decay=0.1, clip_norm=100.0), 1),
    "warmuplr, accum_grad 2": (dict(lr=1e-2, warmup_steps=2, clip_norm=0.3), 2),
}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_optimizer_matches_optax(case):
    """Five updates on fixed gradients, the params against optax's chain
    (clip_by_global_norm, adamw) and MultiSteps; f32 (tolerance: f32
    rounding of the update, well under one lr-sized step)."""
    kw, accum = OPTIM_CASES[case]
    ocfg_j, ocfg_t = joptim.OptimConfig(**kw), toptim.OptimConfig(**kw)
    rng = np.random.default_rng(6)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * (i + 1) for p in params] for i in range(5 * accum)]
    tx = joptim.make_optimizer(ocfg_j)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = toptim.AdamW(tp, ocfg_t, accum_grad=accum)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    if ocfg_t.moment_dtype == "bfloat16":
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)
        assert all(n.dtype == torch.float32 for n in opt.nu)
    assert opt.count == 5


def test_schedules_match_optax_counts():
    """The rate of each update n is the schedule at n previous updates."""
    for kw in (dict(warmup_steps=4), dict(schedule="linear", warmup_steps=4), dict(schedule="constant")):
        jsched = joptim.make_schedule(joptim.OptimConfig(**kw))
        tsched = toptim.make_schedule(toptim.OptimConfig(**kw))
        for n in range(8):
            assert tsched(n) == pytest.approx(float(jsched(n)), rel=1e-6)
    w = toptim.make_schedule(toptim.OptimConfig())
    assert w(0) == w(1) and w(2) > w(1)


def test_bf16_parameters_train_through_f32_masters():
    """A bf16 parameter is updated on its f32 master and gets its rounded
    copy, so updates below bf16's resolution accumulate."""
    p = torch.ones(4, dtype=torch.bfloat16)
    opt = toptim.AdamW([p], toptim.OptimConfig(lr=1e-4, schedule="constant"))
    for _ in range(20):
        opt.update([torch.ones(4, dtype=torch.bfloat16)])
    assert opt.masters[0].dtype == torch.float32
    np.testing.assert_allclose(opt.masters[0].numpy(), 1 - 20e-4, rtol=1e-5)
    assert torch.equal(p, opt.masters[0].bfloat16())


# ---- the model ----


def _jax_loss_and_grads(jmodel, variables, batch, epoch):
    def f(params):
        return jmodel.apply({**variables, "params": params}, _jbatch(batch), jax.random.PRNGKey(0), epoch, train=True)

    (loss, stats), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    return float(loss), {k: float(v) for k, v in stats.items()}, flax_to_state_dict({"params": grads})


def _assert_grads_close(model, ref, rtol, atol_frac):
    """Each parameter's gradient against JAX's, with an absolute floor of
    ``atol_frac`` times that gradient's largest magnitude, and of 1e-6 for
    the gradients that are zero in exact arithmetic (the attention key
    biases, which softmax cancels: both sides hold f32 noise there)."""
    names = {n for n, _ in model.named_parameters()}
    assert names == set(ref), names ^ set(ref)
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), r, rtol=rtol, atol=max(atol_frac * np.abs(r).max(), 1e-6), err_msg=name
        )


@pytest.mark.parametrize("epoch,remat", [(0, False), (6, True)])
def test_ts_model_loss_and_grads_match_jax(models, epoch, remat, monkeypatch):
    """Loss, every stat and every parameter's gradient, on the flash route
    (T = 2 + 256); epoch 6 is past both warm-ups (AAM margin 0.25, ASP
    gamma 6) and recomputes the blocks in the backward. f32: the loss to
    1e-5 relative, gradients to 1e-3 relative plus 1e-4 of each tensor's
    largest entry (summation order through 2 + 2 layers, CTC and flash)."""
    jmodel, variables = models
    batch = _batch(1)
    loss_ref, stats_ref, grads_ref = _jax_loss_and_grads(jmodel, variables, batch, epoch)
    model = _port_model(variables, remat=remat)
    calls = _count_plain_calls(monkeypatch)
    loss, stats = model(_tbatch(batch), None, epoch, train=True)
    loss.backward()
    assert set(stats) == set(stats_ref)
    for k, v in stats_ref.items():
        assert stats[k].item() == pytest.approx(v, rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-5)
    _assert_grads_close(model, grads_ref, rtol=1e-3, atol_frac=1e-4)
    # the encoder self-attention took the flash route: each block's forward
    # (twice with remat) and both backward kernels once per block
    assert calls == {"fwd": 4 if remat else 2, "bwd_dq": 2, "bwd_dkv": 2}


def _count_plain_calls(monkeypatch):
    """Count the calls of the three flash kernels' plain versions (what the
    wrappers run on the CPU)."""
    from robustsq_whisper_torch.ops import flash_attention as tf

    calls = {}
    for kind in ("fwd", "bwd_dq", "bwd_dkv"):
        name = f"flash_attention_{kind}_plain"
        calls[kind] = 0

        def counted(*a, _f=getattr(tf, name), _k=kind, **kw):
            calls[_k] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(tf, name, counted)
    return calls


@pytest.mark.parametrize("mode", ["full", "lora", "frozen_backbone"])
def test_train_steps_match_jax(models, mode):
    """Three steps of make_train_step against JAX's in each mode (LoRA from
    the converted JAX factors): stats every step, then every parameter (and
    LoRA factor). Clipping fires (grad norms > 1). Adam divides each
    gradient by its own size, so f32 noise on small gradients (1e-6
    absolute, from the CTC posteriors) moves a first update by a few
    percent of a step: the parameters agree to 1e-5 absolute, a tenth of
    one lr 1e-4 step, and Adam eps 1e-5 keeps noise on the gradients that
    are zero in exact arithmetic from being scaled up to a full step."""
    jmodel, variables = models
    batch = _batch(2)
    okw = dict(lr=1e-4, schedule="constant", eps=1e-5)
    jcfg = jstep.TrainConfig(mode=mode, optim=joptim.OptimConfig(**okw), lora=jlora.LoraConfig(rank=2))
    jstate, tx = jstep.create_train_state(jax.random.PRNGKey(3), variables, jcfg)
    jfn = jstep.make_train_step(jmodel, tx, jcfg, donate=False)

    model = _port_model(variables)
    tcfg = tstep.TrainConfig(mode=mode, optim=toptim.OptimConfig(**okw), lora=tlora.LoraConfig(rank=2))
    lora = flax_lora_to_port(jstate.lora) if mode == "lora" else None
    state = tstep.create_train_state(model, tcfg, device="cpu", lora=lora)
    fn = tstep.make_train_step(model, tcfg, device="cpu")
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert bool(frozen) == (mode != "full")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        jstate, jstats = jfn(jstate, _jbatch(batch), jax.random.PRNGKey(i), 6)
        state, stats = fn(state, _tbatch(batch), None, 6)
        assert set(stats) == set(jstats)
        for k, v in jstats.items():
            # f32; the gradient norm to 5e-4: it is dominated by the CTC
            # gradient, whose alpha-beta posteriors over 256 frames differ
            # from optax's by up to 2e-4 relative
            tol = 5e-4 if k == "grad_norm" else 1e-4
            assert stats[k].item() == pytest.approx(float(v), rel=tol, abs=1e-6), (i, k)
        assert float(jstats["grad_norm"]) > 1.0
    assert state.step == 3
    ref = flax_to_state_dict({"params": jstate.params})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
        if name in frozen:
            assert torch.equal(p, before[name]), name
    if mode == "lora":
        jl = flax_lora_to_port(jstate.lora)
        assert set(jl) == set(state.lora) and len(jl) > 0
        for name, (a, b) in state.lora.items():
            np.testing.assert_allclose(a.detach().numpy(), jl[name][0].numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(b.detach().numpy(), jl[name][1].numpy(), rtol=0, atol=1e-5)
            assert b.abs().max() > 0


def test_accum_grad_updates_every_second_step(models):
    """accum_grad=2: no change after the first micro-step; after the second
    the update from the mean of both micro-batches' gradients, as JAX's
    optax.MultiSteps (params to 1e-5 absolute, a tenth of an lr 1e-4 step,
    as in test_train_steps_match_jax)."""
    jmodel, variables = models
    okw = dict(lr=1e-4, schedule="constant", eps=1e-5)
    jcfg = jstep.TrainConfig(optim=joptim.OptimConfig(**okw), accum_grad=2)
    jstate, tx = jstep.create_train_state(jax.random.PRNGKey(0), variables, jcfg)
    jfn = jstep.make_train_step(jmodel, tx, jcfg, donate=False)
    model = _port_model(variables)
    tcfg = tstep.TrainConfig(optim=toptim.OptimConfig(**okw), accum_grad=2)
    state = tstep.create_train_state(model, tcfg, device="cpu")
    fn = tstep.make_train_step(model, tcfg, device="cpu")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, seed in enumerate((3, 4)):
        jstate, _ = jfn(jstate, _jbatch(_batch(seed)), jax.random.PRNGKey(0), 0)
        state, _ = fn(state, _tbatch(_batch(seed)), None, 0)
        if i == 0:
            assert all(torch.equal(p, p0[n]) for n, p in model.named_parameters())
    assert state.step == 2 and state.opt.count == 1
    ref = flax_to_state_dict({"params": jstate.params})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_qformer_in_training_mode_at_rate_zero_matches_jax(models):
    """train=True with both dropout rates 0 is the deterministic Qformer
    (f32, one post-LN layer: 1e-5)."""
    jmodel, variables = models
    rng = np.random.default_rng(7)
    mem = rng.standard_normal((B, 40, 64)).astype(np.float32)
    enr = rng.standard_normal((B, 30, 64)).astype(np.float32)
    ml, el = np.array([40, 25, 33], np.int32), np.array([30, 11, 20], np.int32)
    ref = jmodel.apply(
        variables, *map(jnp.asarray, (mem, ml, enr, el)), False, jax.random.PRNGKey(1),
        method=lambda m, *a: m.encoder.qformer(*a),
    )
    model = _port_model(variables)
    got = model.encoder.qformer(*map(torch.from_numpy, (mem, ml, enr, el)), train=True, generator=torch.Generator())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), _np(r), rtol=1e-5, atol=1e-5)


def test_remat_changes_nothing_but_memory(models):
    _, variables = models
    batch = _tbatch(_batch(5))
    grads = []
    for remat in (False, True):
        model = _port_model(variables, remat=remat)
        loss, _ = model(batch, None, 0, train=True)
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        torch.testing.assert_close(g, grads[1][1][n], rtol=0, atol=0)


# ---- dropout and SpecAugment, by their properties ----


def test_dropout_is_inverted_and_off_in_eval():
    from robustsq_whisper_torch.ops.attention import dropout

    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    assert abs(y.mean().item() - 1.0) < 5e-3  # inverted: the mean is kept
    assert dropout(x, 0.0, None) is x


def test_qformer_dropout_only_in_training(models):
    _, variables = models
    model = _port_model(variables, qformer_hidden_dropout=0.1, qformer_attention_dropout=0.1)
    rng = np.random.default_rng(8)
    args = tuple(map(torch.from_numpy, (
        rng.standard_normal((B, 40, 64)).astype(np.float32), np.array([40, 30, 20]),
        rng.standard_normal((B, 30, 64)).astype(np.float32), np.array([30, 30, 9]),
    )))
    q = model.encoder.qformer
    det = q(*args)
    assert all(torch.equal(a, b) for a, b in zip(det, q(*args, train=False, generator=torch.Generator())))
    t1 = q(*args, train=True, generator=torch.Generator().manual_seed(1))
    t1b = q(*args, train=True, generator=torch.Generator().manual_seed(1))
    t2 = q(*args, train=True, generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(a, b) for a, b in zip(t1, t1b))  # the generator decides
    assert not torch.equal(t1[0], t2[0]) and not torch.equal(t1[0], det[0])


def test_specaug_mask_counts_and_width_caps():
    from robustsq_whisper_torch.audio.specaug import SpecAugConfig, apply_masks, draw_masks

    cfg = SpecAugConfig()
    b, n_mels, frames = 64, 80, 3000
    feats = torch.rand(b, n_mels, frames) + 1.0  # never the mask value
    lens = torch.randint(200, frames + 1, (b,))
    lens[0] = 10  # cap max(1, int(10 * 0.05)) = 1
    g = torch.Generator().manual_seed(0)
    keep_f, keep_t = draw_masks(feats, lens, cfg, g)
    masked_f = (~keep_f).sum(1)
    masked_t = (~keep_t).sum(1)
    assert (masked_f <= cfg.num_freq_masks * cfg.freq_mask_width).all()
    cap = torch.clamp((lens * cfg.time_mask_width_ratio).long(), 1, cfg.time_mask_width)
    assert (masked_t <= cfg.num_time_masks * cap).all()
    assert masked_t[0] <= 2 and masked_f.float().mean() > 5 and masked_t.float().mean() > 5
    # each masked run of the time axis is one span no wider than the cap
    out = apply_masks(feats, keep_f, keep_t, cfg.mask_value)
    assert torch.equal(out == 0, ~(keep_f[:, :, None] & keep_t[:, None, :]))
    assert torch.equal(out[keep_f[:, :, None] & keep_t[:, None, :]], feats[keep_f[:, :, None] & keep_t[:, None, :]])


def test_specaug_in_training_only(models):
    """SpecAugment changes the training loss and not the eval one."""
    _, variables = models
    model = TSASRModel(WhisperDims(**DIMS), TSEncoderConfig(**TS), TSModelConfig(**{**CFG, "use_specaug": True}))
    load_flax(model, variables)
    batch = _tbatch(_batch(6))
    with torch.no_grad():
        l_eval = [model(batch, torch.Generator().manual_seed(s), 0, train=False)[0] for s in (0, 1)]
        l_train = [model(batch, torch.Generator().manual_seed(s), 0, train=True)[0] for s in (0, 1)]
    assert l_eval[0] == l_eval[1] and l_train[0] != l_train[1]


# ---- LoRA, conversion and initialisers ----


def test_lora_conversion_and_merge_match_jax(models):
    """The JAX LoRA tree (stacked Whisper blocks and Qformer layers) carried
    over per layer; merged weights equal JAX's merge_lora (f32, exact up to
    one rounding of the product)."""
    _, variables = models
    cfg_j = jlora.LoraConfig(rank=2)
    jl = jlora.init_lora(jax.random.PRNGKey(4), variables["params"], cfg_j)
    jl = {  # a nonzero b, so the merge changes the weights
        k: {"a": v["a"], "b": 0.1 * jax.random.normal(jax.random.PRNGKey(i), v["b"].shape)}
        for i, (k, v) in enumerate(sorted(jl.items()))
    }
    merged_ref = flax_to_state_dict({"params": jlora.merge_lora(variables["params"], jl, cfg_j)})
    model = _port_model(variables)
    port = flax_lora_to_port(jl)
    targets = tlora.lora_targets(model, tlora.LoraConfig(rank=2))
    assert set(port) == set(targets)
    n_whisper = 2 * 4 + 2 * 8  # encoder self q/k/v/o and decoder self + cross, 2 layers each
    n_qformer = 8  # one Qformer layer: attention + crossattention
    assert len(port) == n_whisper + n_qformer
    merged = tlora.merge_lora(model.state_dict(), port, tlora.LoraConfig(rank=2))
    assert set(merged_ref) <= set(merged)  # every parameter (the buffers aside)
    for name, ref in merged_ref.items():
        np.testing.assert_allclose(merged[name].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    # a model with the factors attached computes with the merged weights
    tlora.attach_lora(model, port, tlora.LoraConfig(rank=2))
    lin = targets["encoder.encoder.blocks.1.attn.value.weight"]
    torch.testing.assert_close(lin.effective_weight(), merged["encoder.encoder.blocks.1.attn.value.weight"])


def test_init_lora_is_identity_at_start(models):
    _, variables = models
    model = _port_model(variables)
    lora = tlora.init_lora(model, tlora.LoraConfig(rank=4), seed=1)
    sd = model.state_dict()
    merged = tlora.merge_lora(sd, lora, tlora.LoraConfig(rank=4))
    assert all(torch.equal(merged[k], sd[k]) for k in sd)
    a, b = lora["decoder.decoder.blocks.0.cross_attn.key.weight"]
    assert a.shape == (64, 4) and b.shape == (4, 64) and not b.any()


def test_seeded_init_heads_match_the_flax_initialisers():
    """ASP projection xavier-uniform, AAM classifier lecun-normal (fan-in
    from the second-to-last axis), the CTC head N(0, 1/fan_in); moments
    within sampling error of the flax initialisers'."""
    from robustsq_whisper_torch.init import init_params

    dims = WhisperDims(**{**DIMS, "n_audio_state": 256})
    model = init_params(TSASRModel(dims, TSEncoderConfig(**TS), TSModelConfig(**{**CFG, "num_speakers": 400})), 0)
    w = model.asp.projection.weight.detach()
    limit = np.sqrt(6 / (512 + 256))
    assert w.abs().max() <= limit and w.abs().max() > 0.99 * limit
    assert w.std().item() == pytest.approx(limit / np.sqrt(3), rel=0.02)
    c = model.aam.classifier.detach()
    assert c.std().item() == pytest.approx(400 ** -0.5, rel=0.02)
    assert c.abs().max() <= 2 * 400 ** -0.5 / 0.87962566103423978 + 1e-6
    jw = jspk.AAMSoftmaxHead(400, 256).init(jax.random.PRNGKey(0), jnp.ones((1, 256)), jnp.zeros((1,), jnp.int32))
    assert float(jnp.std(jw["params"]["classifier"])) == pytest.approx(c.std().item(), rel=0.03)
    assert not model.asp.projection.bias.any()

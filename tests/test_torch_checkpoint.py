"""The port's checkpoints: exact save / restore round trips, the JAX
package's step semantics (a duplicate step raises unless ``overwrite``;
retention and pruning keep the latest step), the full training state
resuming bit for bit, and the serving restore's bf16 LoRA merge."""

import os

import numpy as np
import pytest
import torch

from robustsq_whisper_torch.init import init_params
from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig, WhisperDims
from robustsq_whisper_torch.train import TrainConfig, create_train_state, make_train_step
from robustsq_whisper_torch.train import checkpoint as ckpt
from robustsq_whisper_torch.train.lora import LoraConfig, merge_lora
from robustsq_whisper_torch.train.optim import OptimConfig

B, SAMPLES, E_SAMPLES = 2, 5120, 3200


def _model(seed=0):
    dims = WhisperDims(n_audio_ctx=16, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
                       n_text_ctx=16, n_text_state=32, n_text_head=2, n_text_layer=1, n_vocab=50)
    ts = TSEncoderConfig(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
                         qformer_heads=2, qformer_intermediate_size=64,
                         qformer_hidden_dropout=0.0, qformer_attention_dropout=0.0)
    cfg = TSModelConfig(vocab_size=50, sos=1, eos=2, startofprev=3, num_speakers=4,
                        num_negatives=1, use_specaug=False)
    return init_params(TSASRModel(dims, ts, cfg), seed)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    neg = np.full((B, B), -10000.0, np.float32)
    neg[np.arange(B), (np.arange(B) + 1) % B] = 1.0
    return {
        "speech": torch.from_numpy((rng.standard_normal((B, SAMPLES)) * 0.05).astype(np.float32)),
        "speech_lens": torch.tensor([SAMPLES, SAMPLES - 900]),
        "enroll": torch.from_numpy((rng.standard_normal((B, E_SAMPLES)) * 0.05).astype(np.float32)),
        "enroll_lens": torch.tensor([E_SAMPLES, E_SAMPLES - 500]),
        "text": torch.from_numpy(rng.integers(4, 40, (B, 5)).astype(np.int32)),
        "text_lens": torch.tensor([5, 4], dtype=torch.int32),
        "neg_logits": torch.from_numpy(neg),
        "spk_labels": torch.tensor([0, 1]),
    }


def _cfg(mode, moment_dtype="float32"):
    return TrainConfig(mode=mode, optim=OptimConfig(lr=1e-3, schedule="constant",
                                                    moment_dtype=moment_dtype),
                       lora=LoraConfig(rank=2, alpha=4.0))


def _state(mode="full", dtype=torch.float32, seed=0, **kw):
    model = _model(seed)
    if dtype != torch.float32:
        model.set_compute_dtype(dtype)
    return create_train_state(model, _cfg(mode, **kw), seed=seed, device="cpu")


def test_save_restore_weights_exact(tmp_path):
    state = _state("lora", torch.bfloat16)
    for a, b in state.lora.values():
        b.data.normal_()
    state.step = 7
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), 7, state, epoch=3)
    assert path.endswith(os.path.join("ck", "7"))
    assert ckpt.latest_step(str(tmp_path / "ck")) == 7
    assert ckpt.latest_step(str(tmp_path / "nothing")) is None
    params, buffers, lora, step, epoch = ckpt.restore_weights(str(tmp_path / "ck"))
    assert (step, epoch) == (7, 3)
    own = dict(state.model.named_parameters())
    assert params.keys() == own.keys()
    for n, p in own.items():
        assert params[n].dtype == p.dtype and torch.equal(params[n], p.detach()), n
    sd = state.model.state_dict()
    assert buffers and all(torch.equal(buffers[n], sd[n]) for n in buffers)
    assert lora.keys() == state.lora.keys()
    for n, (a, b) in state.lora.items():
        assert torch.equal(lora[n][0], a.detach()) and torch.equal(lora[n][1], b.detach())
    with pytest.raises(FileNotFoundError):
        ckpt.restore_weights(str(tmp_path / "nothing"))


def test_duplicate_step_raises_unless_overwrite(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, state, epoch=0)
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save_checkpoint(d, 1, state, epoch=0)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    ckpt.save_checkpoint(d, 1, state, epoch=5, overwrite=True)
    params, _, _, _, epoch = ckpt.restore_weights(d)
    name, p = next(iter(state.model.named_parameters()))
    assert epoch == 5 and torch.equal(params[name], p.detach())
    assert ckpt.all_steps(d) == [1] and not [f for f in os.listdir(d) if f.startswith(".")]


def test_retention_and_prune_keep_protected_and_latest(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, state, epoch=s, keep=3)
    assert ckpt.all_steps(d) == [2, 3, 4]
    for s in (5, 6, 7):
        ckpt.save_checkpoint(d, s, state, epoch=s, keep=None)
    ckpt.prune_checkpoints(d, keep=1, protected=(2, 5))
    # protected 2 and 5, the latest 7, and the newest deletable one (6)
    assert ckpt.all_steps(d) == [2, 5, 6, 7]
    ckpt.prune_checkpoints(d, keep=0, protected=())
    assert ckpt.all_steps(d) == [7]
    ckpt.prune_checkpoints(str(tmp_path / "none"), keep=0)


@pytest.mark.parametrize("mode,dtype,moments", [
    ("full", torch.bfloat16, "bfloat16"),
    ("lora", torch.float32, "float32"),
], ids=["full-bf16", "lora-f32"])
def test_resume_continues_bit_for_bit(tmp_path, mode, dtype, moments):
    """Two steps, save, a third step; a fresh state restored from the
    checkpoint takes the same third step to the same weights."""
    state = _state(mode, dtype, moment_dtype=moments)
    step = make_train_step(state.model, _cfg(mode, moments), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        state, _ = step(state, _batch(i), gen, epoch=0)
    ckpt.save_checkpoint(str(tmp_path / "ck"), state.step, state, epoch=1, generator=gen)
    state, stats = step(state, _batch(2), gen, epoch=1)

    fresh = _state(mode, dtype, seed=1, moment_dtype=moments)
    fresh, epoch, gstate = ckpt.restore_checkpoint(str(tmp_path / "ck"), fresh)
    gen2 = torch.Generator()
    gen2.set_state(gstate)
    assert (fresh.step, epoch) == (2, 1)
    fresh, stats2 = step(fresh, _batch(2), gen2, epoch=1)
    assert torch.equal(stats["loss"], stats2["loss"])
    for (n, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
    for t, u in zip(state.trainables, fresh.trainables):
        assert torch.equal(t, u)


def test_restore_with_other_layout_restores_weights_only(tmp_path):
    state = _state("lora")
    ckpt.save_checkpoint(str(tmp_path / "ck"), 3, state, epoch=0)
    other = _state("full", seed=1)
    other, _, _ = ckpt.restore_checkpoint(str(tmp_path / "ck"), other)
    for (n, p), q in zip(state.model.named_parameters(), other.model.parameters()):
        assert torch.equal(p, q), n
    assert other.step == 0 and other.opt.count == 0


def test_serving_restore_merges_lora_in_bf16(tmp_path):
    state = _state("lora")
    gen = torch.Generator().manual_seed(1)
    for a, b in state.lora.values():
        b.data.copy_(torch.randn(b.shape, generator=gen) * 0.1)
    ckpt.save_checkpoint(str(tmp_path / "ck"), 1, state, epoch=0)
    cfg = _cfg("lora")
    sd, step, epoch = ckpt.restore_serving_variables(str(tmp_path / "ck"), torch.bfloat16, cfg)
    params = {n: p.detach().to(torch.bfloat16) for n, p in state.model.named_parameters()}
    lora = {n: (a.detach().bfloat16(), b.detach().bfloat16()) for n, (a, b) in state.lora.items()}
    want = merge_lora(params, lora, cfg.lora)
    assert (step, epoch) == (0, 0)  # the state's own step, as in the JAX package
    for n, w in want.items():
        assert sd[n].dtype == torch.bfloat16 and torch.equal(sd[n], w), n
    # the merge changed every adapted weight
    assert all(not torch.equal(sd[n], params[n]) for n in lora)
    # buffers as stored (f32)
    assert sd["encoder.encoder.positional_embedding"].dtype == torch.float32
    # a full-mode restore ignores nothing and merges nothing
    sd_full, _, _ = ckpt.restore_serving_variables(str(tmp_path / "ck"), torch.bfloat16, _cfg("full"))
    assert all(torch.equal(sd_full[n], params[n]) for n in params)

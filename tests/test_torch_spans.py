"""The program's spans (``utils/profiling.annotate``) on the CPU: with no
profiler recording, a span is the one shared null context and calls
nothing of the profiler; under ``utils/profiling.trace`` a tiny
``decode_dataset`` run (greedy, greedy without the early stop, beam 2)
and a tiny ``run_training`` step (full and LoRA) leave their ``rsq:``
ranges in the chrome trace, nested as the profiling module's docstring
says, and the tokens do not change under the profiler."""

import json

import numpy as np
import pytest
import torch

from robustsq_whisper_torch.decode.pipeline import decode_dataset, serving_modules
from robustsq_whisper_torch.decode.search import DecodeConfig
from robustsq_whisper_torch.init import init_params
from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig, WhisperDims
from robustsq_whisper_torch.train import OptimConfig, TrainConfig
from robustsq_whisper_torch.train.lora import LoraConfig
from robustsq_whisper_torch.train.loop import LoopConfig, run_training
from robustsq_whisper_torch.utils import profiling

DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=256, n_audio_state=64,
    n_audio_head=2, n_audio_layer=2, n_text_ctx=32, n_text_state=64,
    n_text_head=2, n_text_layer=2,
)
TS = dict(
    num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
    qformer_heads=2, qformer_intermediate_size=64,
    qformer_hidden_dropout=0.0, qformer_attention_dropout=0.0,
)
CFG = dict(vocab_size=64, sos=1, eos=2, startofprev=3, num_speakers=8, num_negatives=2,
           use_specaug=False)
B, SAMPLES, E_SAMPLES, SR = 2, 512 * 160, 200 * 160, 16000
DECODE_SPANS = ("rsq:decode.frontend", "rsq:decode.frontend_copy", "rsq:decode.encode",
                "rsq:decode.search", "rsq:decode.consume", "rsq:decode.prefill", "rsq:decode.step",
                "rsq:decode.stop_check")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0):
    model = TSASRModel(WhisperDims(**DIMS), TSEncoderConfig(**TS), TSModelConfig(**CFG))
    return init_params(model, seed)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(4, 60, (B, 6)).astype(np.int32)
    text_lens = np.array([6, 4], np.int32)
    text[np.arange(6)[None] >= text_lens[:, None]] = -1
    return {
        "utt_ids": [f"u{i}" for i in range(B)],
        "speech": (rng.standard_normal((B, SAMPLES)) * 0.05).astype(np.float32),
        "speech_lens": np.array([SAMPLES, SAMPLES - 9000], np.int32),
        "enroll": (rng.standard_normal((B, E_SAMPLES)) * 0.05).astype(np.float32),
        "enroll_lens": np.array([E_SAMPLES, E_SAMPLES - 5000], np.int32),
        "text": text,
        "text_lens": text_lens,
        "neg_logits": np.where(np.eye(B, dtype=bool), -10000.0, 1.0).astype(np.float32),
        "spk_labels": np.arange(B, dtype=np.int32),
    }


class OneBatch:
    """A dataset of one batch, for ``decode_dataset`` and ``run_training``."""

    sample_rate = SR

    def __init__(self, batch):
        self.batch = batch
        self.text = {u: "" for u in batch["utt_ids"]}

    def batches(self, batch_size, shuffle=False, drop_last=False):
        yield self.batch


class IdTokenizer:
    def decode(self, ids):
        return " ".join(str(int(t)) for t in ids)


def _spans(trace_dir):
    (path,) = trace_dir.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith("rsq:")]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent, eps=1e-3):
    return parent[1] - eps <= child[1] and child[1] + child[2] <= parent[1] + parent[2] + eps


def _within_one(children, parents):
    return all(sum(_inside(c, p) for p in parents) == 1 for c in children)


def test_annotate_off_is_the_shared_null_context(monkeypatch):
    """No profiler recording (none yet, and again after a capture): the
    same null context every time, and no ``record_function`` or NVTX call."""
    calls = []

    def counted(*a, **kw):
        calls.append(a)
        raise AssertionError("record_function called with no profiler recording")

    for mod in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(mod, "record_function", counted)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", counted)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", counted)
    first = profiling.annotate("rsq:decode.step")
    with first, profiling.annotate("rsq:decode.stop_check"):
        pass
    assert profiling.annotate("rsq:train.step") is first
    assert calls == []


def test_annotate_is_off_again_after_a_capture(tmp_path):
    with profiling.trace(str(tmp_path)):
        on = profiling.annotate("rsq:decode.step")
        assert isinstance(on, torch.autograd.profiler.record_function)
        with on:
            torch.ones(4).sum()
    off = profiling.annotate("rsq:decode.step")
    assert off is profiling.annotate("rsq:train.step")
    assert not isinstance(off, torch.autograd.profiler.record_function)
    assert [s[0] for s in _spans(tmp_path)] == ["rsq:decode.step"]


@pytest.fixture(scope="module")
def serving():
    model = _model()
    dims = WhisperDims(**DIMS)
    return serving_modules(dims, TSEncoderConfig(**TS), TSModelConfig(**CFG), model.state_dict(),
                           torch.float32, "cpu")


DECODE_CASES = {
    "greedy": dict(),
    "greedy-no-early-stop": dict(stop_early=False),
    "beam2": dict(beam_size=2),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_spans(serving, tmp_path, case):
    """Every decode span in the trace, the two waveform copies of the
    frontend inside it; one ``rsq:decode.step`` an iteration
    (a ``TSDecoder.step`` call each but the last); each stop check and each
    ``TSDecoder.step`` call inside a step, and with beams a selection in
every step and a cache reorder in every step that calls it; the prefill
inside the search;
    the tokens those of a run without the profiler."""
    enc, dec = serving
    dcfg = DecodeConfig(max_new_tokens=6, eot=2, init_tokens=(1, 4), quantize_cross_kv=True,
                        **DECODE_CASES[case])
    batch = _batch(1)
    untraced = decode_dataset(enc, dec, OneBatch(batch), IdTokenizer(), dcfg, batch_size=B,
                              device="cpu")
    calls = []
    step = dec.step

    def counted(*a, **kw):
        calls.append(None)
        return step(*a, **kw)

    dec.step = counted
    try:
        with profiling.trace(str(tmp_path)):
            traced = decode_dataset(enc, dec, OneBatch(batch), IdTokenizer(), dcfg, batch_size=B,
                                    device="cpu")
    finally:
        del dec.step
    assert traced.hyps == untraced.hyps and len(traced.hyps) == B
    spans = _spans(tmp_path)
    for name in DECODE_SPANS:
        assert _named(spans, name), name
    for name in ("rsq:decode.frontend", "rsq:decode.encode", "rsq:decode.search",
                 "rsq:decode.consume", "rsq:decode.prefill"):
        assert len(_named(spans, name)) == 1, name
    steps = _named(spans, "rsq:decode.step")
    assert len(steps) == len(calls) + 1
    checks = _named(spans, "rsq:decode.stop_check")
    assert len(checks) in (len(steps), len(steps) - 1)  # none at the last allowed step
    assert _within_one(checks, steps)
    (search,) = _named(spans, "rsq:decode.search")
    assert _within_one(_named(spans, "rsq:decode.prefill") + steps, [search])
    (frontend,), (encode,) = _named(spans, "rsq:decode.frontend"), _named(spans, "rsq:decode.encode")
    (consume,) = _named(spans, "rsq:decode.consume")
    assert frontend[1] + frontend[2] <= encode[1] <= search[1] <= consume[1]
    copies = _named(spans, "rsq:decode.frontend_copy")  # the speech's and the enrollments'
    assert len(copies) == 2 and _within_one(copies, [frontend])
    if DECODE_CASES[case].get("beam_size", 1) > 1:  # one selection a step, a reorder a call
        selects = _named(spans, "rsq:decode.beam_select")
        reorders = _named(spans, "rsq:decode.beam_reorder")
        assert len(selects) == len(steps) and _within_one(selects, steps)
        assert len(reorders) == len(calls) and _within_one(reorders, steps)


@pytest.mark.parametrize("mode", ["full", "lora"])
def test_train_spans(tmp_path, mode):
    """One ``run_training`` step: ``rsq:train.forward``, ``.backward`` and
    ``.optimizer`` once each, in that order, inside the one
    ``rsq:train.step``; the step's loss and parameters those of a run
    without the profiler."""
    tcfg = TrainConfig(mode=mode, optim=OptimConfig(lr=1e-3, schedule="constant"),
                       lora=LoraConfig(rank=2))
    loop = LoopConfig(num_epochs=1, batch_size=B, log_every=1)
    out = {}
    for traced in (False, True):
        logged = []
        with profiling.trace(str(tmp_path) if traced else None):
            state = run_training(_model(), OneBatch(_batch(2)), tcfg, loop, device="cpu",
                                 metrics_hook=lambda s, v: logged.append(v))
        out[traced] = (logged[0]["loss"], [t.detach().clone() for t in state.trainables])
    assert np.isfinite(out[False][0]) and out[True][0] == out[False][0]
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    spans = _spans(tmp_path)
    (step,) = _named(spans, "rsq:train.step")
    parts = [_named(spans, f"rsq:train.{p}") for p in ("forward", "backward", "optimizer")]
    assert [len(p) for p in parts] == [1, 1, 1]
    (fwd,), (bwd,), (opt,) = parts
    assert all(_inside(p, step) for p in (fwd, bwd, opt))
    assert fwd[1] + fwd[2] <= bwd[1] and bwd[1] + bwd[2] <= opt[1]

"""The greedy loop's CUDA-graph engagement and its stop check that does not
block, on the CPU.

``graph_step_applies`` decides per path where the token step replays as a
CUDA graph; here one case per path. The stop check (``search.StopFlags``)
runs on the CPU with events that complete at once, or that lag behind the
host by a few queries as the card's may: the tokens and scores stay the
JAX greedy decoder's on a batch whose rows emit eot early (the final layer
norm's bias turned towards eot's embedding), a wrapper on ``dec.step``
built like the benchmark's sees one call per token in order, and a lag
costs at most ``RUN_AHEAD`` calls more. The graph itself runs on the card
(``tests/test_torch_cuda.py::test_greedy_step_graph_equals_eager``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from portbench import harness
from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.decode.search import build_beam_decoder as j_beam
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode import search
from robustsq_whisper_torch.decode.search import DecodeConfig, build_greedy_decoder
from robustsq_whisper_torch.decode.step_graph import StepGraph, StepGraphs, graph_step_applies
from robustsq_whisper_torch.models import TSDecoder, WhisperDims

DIMS = dict(
    n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=128,
    n_text_head=2, n_text_layer=3,
)
SOP, EOT, B = 3, 2, 6
BASE = dict(max_new_tokens=12, eot=EOT, init_tokens=(1, 4), quantize_cross_kv=True,
            min_new_tokens=2)
# the final layer norm's bias, this far along eot's embedding: rows emit
# eot first at steps 2-4 (every row done at step 4); 0 leaves them running
EOT_BIAS = {"early": 2.0, "late": 0.0}


def _decoder(**kw):
    return TSDecoder(WhisperDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((B, 40, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((B, 5, 128)).astype(np.float32) * 3
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4)
    variables = jax.jit(jd.init)(
        jax.random.PRNGKey(5), jnp.asarray(memory), jnp.zeros((B, 4), jnp.int32),
        jnp.asarray(prompt),
    )
    emb = np.asarray(variables["params"]["decoder"]["token_embedding"]["embedding"][EOT])
    out = {}
    for name, c in EOT_BIAS.items():
        v = jax.tree_util.tree_map(lambda x: x, variables)
        ln = v["params"]["decoder"]["ln"]
        ln["bias"] = ln["bias"] + c * emb / np.linalg.norm(emb)
        j_out = j_beam(jd, v, JDecodeConfig(**BASE))(jnp.asarray(memory), jnp.asarray(prompt))
        out[name] = (v, np.asarray(j_out[0]), np.asarray(j_out[1]))
    return memory, prompt, out


# ---- where the graph engages

def _applies(dec, device="cuda", layout="flat", **kw):
    return graph_step_applies(dec, device, layout, **kw)


PATHS = {  # name: (decoder keywords, predicate keywords, inference mode, engages)
    "greedy-flat": ({}, {}, True, True),
    "greedy-flat-int8": (dict(self_kv_bits=8), {}, True, True),
    "greedy-tmin": (dict(tmin_self_cache=True), dict(layout="tmin"), True, True),
    "cpu": ({}, dict(device="cpu"), True, False),
    "beam-group": ({}, dict(beam_group=3), True, False),
    "beam-row-map": ({}, dict(row_map=torch.arange(4)), True, False),
    "5d-cache": (dict(flat_self_cache=False), dict(layout="5d"), True, False),
    "multi-token": (dict(flat_self_cache=False), dict(layout="5d", q_len=4), True, False),
    "ragged-pos": ({}, dict(ragged=True), True, False),
    "timestamps": ({}, dict(with_timestamps=True), True, False),
    "vocab-tp": ({}, {}, True, False),
    "outside-inference-mode": ({}, {}, False, False),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_graph_engages_only_on_the_greedy_step(path):
    """Greedy's step on CUDA over the flat (dense or int8) or time-minor
    cache takes the graph; the CPU, a beam step (grouped, or through the
    deferred reorder's row map), the 5-D cache, a multi-token or ragged
    step, the timestamp rules, a vocabulary split across ranks and a step
    outside inference mode do not. The layout is the decoder's own."""
    dec_kw, kw, inference, engages = PATHS[path]
    dec = _decoder(**dec_kw)
    assert dec.decoder.default_layout == kw.get("layout", "flat")
    assert dec.decoder._cache_layout(dec.init_cache(2, 8)) == dec.decoder.default_layout
    if path == "vocab-tp":
        dec.decoder.vocab_tp = SimpleNamespace(rank=0)
    with torch.inference_mode(inference):
        assert _applies(dec, **kw) is engages


def test_one_step_graph_lives_per_decoder():
    """A batch of another shape drops the live graph for its own; the same
    shape finds it again."""
    graphs = StepGraphs()
    a = graphs.get((4, 20, 40))
    assert graphs.get((4, 20, 40)) is a
    b = graphs.get((3, 20, 40))
    assert b is not a and graphs.live is b
    assert graphs.get((4, 20, 40)) is not a


def _rerun_capture(self, dec, qw):
    """``StepGraph._capture`` on the CPU: a stand-in graph whose replay
    runs the step again into the static logits, the warm-up's logits
    returned."""
    td = dec.decoder

    def run():
        return td.step(td.embed(self.token), self.pos, self.cache, self.cross, qw=qw)[0]

    logits = run()
    self.logits = torch.empty_like(logits)
    self.graph = SimpleNamespace(replay=lambda: self.logits.copy_(run()))
    return logits, self.cache


@pytest.mark.parametrize("layout,pq", [("flat", True), ("flat", False), ("tmin", True)])
def test_step_graph_operands_keep_jax_tokens(setup, layout, pq, monkeypatch):
    """The greedy loop over a ``StepGraph``'s static operands, on the CPU
    with a stand-in graph that reruns the step: batches of one shape (the
    second's cross K/V written into the first's buffers, or copied there
    after the dense prefill), then of another and the first again, each the
    JAX greedy decoder's tokens and scores; every ``dec.step`` call hands
    the graph of its batch's shape and gets its static logits back."""
    memory, prompt, out = setup
    variables, _, _ = out["late"]
    monkeypatch.setattr(search, "graph_step_applies", lambda *a, **kw: True)
    monkeypatch.setattr(StepGraph, "_capture", _rerun_capture)
    kw = dict(tmin_self_cache=True) if layout == "tmin" else {}
    jd = JDec(JDims(**DIMS), startofprev_token=SOP, cross_kv_bits=4, **kw)
    dec = load_flax(_decoder(**kw), variables)
    calls, step = [], dec.step

    def captured(*a, **kw):
        logits, cache = step(*a, **kw)
        calls.append((kw["graph"], logits))
        return logits, cache

    dec.step = captured
    cfg = dict(BASE, prefill_quantized=pq)
    run = build_greedy_decoder(dec, DecodeConfig(**cfg), device="cpu")
    j_run = j_beam(jd, variables, JDecodeConfig(**cfg))
    rows = [slice(0, 4), slice(2, 6), slice(0, 3), slice(0, 4)]
    graphs = []
    for r in rows:
        m, p = memory[r], prompt[r]
        if r.stop == 3:  # another memory length too
            m = np.concatenate([m, m[:, :8]], axis=1)
        n = len(calls)
        tok, score = run(torch.from_numpy(m), torch.from_numpy(p))
        j_tok, j_score = j_run(jnp.asarray(m), jnp.asarray(p))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
        np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=1e-4, atol=1e-4)
        graph = calls[n][0]
        assert all(g is graph for g, _ in calls[n:])
        assert all(lg is graph.logits for _, lg in calls[n + 1:])
        graphs.append(graph)
    assert graphs[1] is graphs[0] and graphs[2] is not graphs[1] and graphs[3] is not graphs[0]


# ---- the stop check that does not block

def _lagging(lag):
    """An event class whose ``query`` reads False ``lag`` times after each
    ``record``, as a card still running the step would."""

    class Lagging:
        def record(self):
            self.left = lag

        def query(self):
            if self.left:
                self.left -= 1
                return False
            return True

        def synchronize(self):
            self.left = 0

    return Lagging


STOP_CASES = {  # name: (EOT_BIAS key, event lag in queries)
    "early": ("early", 0),
    "early-lag-2": ("early", 2),
    "early-lag-past-the-bound": ("early", 50),
    "late-lag-3": ("late", 3),
}


def _run_greedy(setup, variables, lag, monkeypatch):
    """Greedy on the CPU with stop-flag events ``lag`` queries late; returns
    (tokens, scores, [(pos, token sent, logits, graph) a ``dec.step`` call])."""
    memory, prompt, _ = setup
    monkeypatch.setattr(search, "_Settled", _lagging(lag))
    dec = load_flax(_decoder(), variables)
    calls = []
    step = dec.step

    def captured(token, pos, cache, cross, **kw):  # the benchmark's LogitCapture, in short
        logits, cache = step(token, pos, cache, cross, **kw)
        calls.append((int(pos), token[:, 0].clone(), logits.clone(), kw["graph"]))
        return logits, cache

    dec.step = captured
    tok, score = build_greedy_decoder(dec, DecodeConfig(**BASE), device="cpu")(
        torch.from_numpy(memory), torch.from_numpy(prompt))
    return tok, score, calls


@pytest.mark.parametrize("case", list(STOP_CASES))
def test_stop_check_keeps_jax_tokens_and_one_call_a_token(setup, case, monkeypatch):
    """Tokens and scores those of JAX's greedy decoder; ``dec.step`` called
    once a token at consecutive positions with the token just emitted; as
    many calls as a loop that stops at once makes, or with lagging events
    at most ``RUN_AHEAD`` more, whose common calls return the same logits."""
    _, prompt, out = setup
    bias, lag = STOP_CASES[case]
    variables, j_tok, j_score = out[bias]
    tok, score, calls = _run_greedy(setup, variables, lag, monkeypatch)
    np.testing.assert_array_equal(tok.numpy(), j_tok)
    np.testing.assert_allclose(score.numpy(), j_score, rtol=1e-4, atol=1e-4)

    max_new = BASE["max_new_tokens"]
    first_eot = [list(r).index(EOT) if EOT in r else max_new for r in j_tok]
    want = min(max(first_eot), max_new - 1)  # the calls of a loop that stops at once
    if bias == "early":
        assert want == 4 and min(first_eot) == 2  # rows stop at different steps
    base = 1 + prompt.shape[1] + len(BASE["init_tokens"])
    assert [c[0] for c in calls] == list(range(base, base + len(calls)))
    for k, (_, sent, _, graph) in enumerate(calls):
        assert graph is None  # the CPU steps eagerly
        assert torch.equal(sent, tok[:, k].long())
    if lag == 0:
        assert len(calls) == want
        return
    assert want <= len(calls) <= min(want + search.RUN_AHEAD, max_new - 1)
    assert len(calls) > want or want == max_new - 1
    # the calls a loop that stops at once makes return the same logits
    _, _, ref = _run_greedy(setup, variables, 0, monkeypatch)
    assert len(ref) == want
    for r, c in zip(ref, calls):
        assert torch.equal(r[2], c[2])


def test_stop_flags_bound_the_run_ahead(monkeypatch):
    """With events that never complete by themselves, the host reads a flag
    only by waiting, and then only on the flag ``RUN_AHEAD`` steps back."""
    monkeypatch.setattr(search, "_Settled", _lagging(10**6))
    flags = search.StopFlags(torch.device("cpu"))
    done = torch.zeros(3, dtype=torch.bool)
    all_done = torch.ones(3, dtype=torch.bool)
    answers = [flags.push(done) for _ in range(search.RUN_AHEAD)]
    answers.append(flags.push(all_done))  # read after RUN_AHEAD more pushes
    answers += [flags.push(done) for _ in range(search.RUN_AHEAD - 1)]
    assert answers == [False] * (2 * search.RUN_AHEAD)
    assert flags.push(done) is True
    assert len(flags.pending) <= search.RUN_AHEAD


# ---- the benchmark's reader of the replays

def _sub(host_ops):
    return SimpleNamespace(sub=SimpleNamespace(t1=1.0, host_ops=list(host_ops), device_ops=[]))


@pytest.mark.parametrize("replays,value", [(3, 100.0), (2, 200.0 / 3), (0, None)])
def test_graph_step_share_reading(replays, value):
    """One greedy loop of four ``rsq:decode.step`` spans (three call
    ``dec.step``): 100 × replays / 3; nothing where the program opens no
    replay span (the parent of this reader)."""
    ops = [("rsq:decode.prefill", 0.0, 5.0)]
    ops += [("rsq:decode.step", 10.0 * (k + 1), 8.0) for k in range(4)]
    ops += [("rsq:decode.graph_replay", 10.0 * (k + 1) + 2, 3.0) for k in range(replays)]
    reader = harness.load_module("metrics", "graph_step_share.decode")
    got = reader.read(_sub(ops))
    assert got == (None if value is None else pytest.approx(value))
    assert reader.read(SimpleNamespace(sub=None)) is None

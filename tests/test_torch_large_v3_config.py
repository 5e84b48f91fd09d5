"""The benchmark's Whisper large-v3 beam-5 configuration on the CPU.

Its ``whisper`` block is the port's ``large-v3`` preset and its token ids
the v3 layout's. The port's beam search (``build_beam_decoder``) gives the
hypotheses and scores of the plain reference's (``portbench/reference/
beam.py``) in float32, at width 64 with the v3 vocabulary. A tiny cut of
the beam cell runs through its driver to ``correct`` true against the plain
reference, with ``beam_mfu.decode`` read under ``--trace 1``, and to
``correct`` false under each fault the cell's readings plant
(``portbench/control_beam.py``).
"""

import copy
import dataclasses

import pytest
import torch

from portbench import control_beam, harness
from portbench.reference.beam import beam_search
from portbench.reference.model import Ref, param_specs
from portbench.tests.tiny import run_cell
from portbench.weights import make_weights
from robustsq_whisper_torch.models.whisper.config import whisper_dims
from robustsq_whisper_torch.tokenizer.whisper_tokenizer import special_tokens_for_vocab

CELL = "qformer_large_v3.decode_beam5_b64"
SEED = 2**32 + 29
# above the tiny cut's CPU readings (logit_err ~0.008, select and score
# gaps ~0) and below each fault's (swapped rows' logit_err 0.12-0.20,
# kth_replaced's select_gap 0.12-0.21, altered_token's score_gap 4.2-5.3)
TINY_LIMITS = {"logit_err": 0.05, "select_gap": 0.05, "score_gap": 0.5}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_config_is_the_preset_with_v3_tokens():
    cell = harness.load_cell(CELL)
    cfg = cell.config
    assert cfg["whisper"] == dataclasses.asdict(whisper_dims("large-v3"))
    assert cfg["reduced"] == []
    st = special_tokens_for_vocab(cfg["whisper"]["n_vocab"])
    assert cfg["model"]["vocab_size"] == st.n_vocab == 51866
    assert cfg["serving"]["init_tokens"] == [st.sot, st.lang("en"), st.transcribe, st.notimestamps]
    assert (cfg["model"]["sos"], cfg["model"]["eos"], cfg["model"]["startofprev"]) == (
        st.sot, st.eot, st.startofprev)
    assert cfg["serving"]["eot"] == st.eot
    assert (cell.traffic["beam_size"], cell.traffic["batch_size"], cell.traffic["driver"]) == (5, 64, "decode_beam")


def tiny_config(dtype="bfloat16"):
    """The configuration at width 64, 2 + 2 layers; the mel bins, the
    vocabulary and the token ids stay large-v3's."""
    c = copy.deepcopy(harness.load_cell(CELL).config)
    c["whisper"].update(n_audio_state=64, n_audio_head=2, n_audio_layer=2, n_text_state=64,
                        n_text_head=2, n_text_layer=2)
    c["encoder"].update(num_query_tokens=4, qformer_hidden_size=32, qformer_heads=2,
                        qformer_intermediate_size=64)
    c["model"]["num_speakers"] = 50
    c["serving"]["dtype"] = dtype
    assert c["whisper"]["n_mels"] == 128 and c["whisper"]["n_vocab"] == 51866
    return c


def tiny_cell():
    cell = harness.load_cell(CELL)
    cell.config = tiny_config()
    cell.traffic = {**cell.traffic, "batch_size": 2, "enc_chunk": 1, "max_new_tokens": 6,
                    "pool_batches": 2, "check_utterances": 2}
    cell.limits = dict(TINY_LIMITS)
    return cell


@pytest.mark.parametrize("seed", [2, 2**32 + 7])
def test_port_beam_search_is_the_reference_beam_search(seed):
    """Both searches over one memory and prompt, float32: the same best
    hypotheses and scores, on seeds whose reference top-k margins (k-th
    against (k+1)-th candidate, every step) clear float32's noise."""
    from portbench import program
    from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder

    cfg = tiny_config("float32")
    sv, k, max_new = cfg["serving"], 5, 8
    weights = make_weights(param_specs(cfg, heads=False), seed, "cpu")
    _, dec = program.serving_modules(cfg, weights, "cpu")
    g = torch.Generator().manual_seed(seed)
    b, nq, d = 2, cfg["encoder"]["num_query_tokens"], cfg["whisper"]["n_text_state"]
    memory = torch.randn(b, cfg["whisper"]["n_audio_ctx"] + nq, d, generator=g)
    prompt = torch.randn(b, nq, d, generator=g)
    dcfg = DecodeConfig(max_new_tokens=max_new, eot=sv["eot"], init_tokens=tuple(sv["init_tokens"]),
                        beam_size=k, quantize_cross_kv=True, prefill_quantized=True)
    tokens, scores = build_beam_decoder(dec, dcfg, "cpu")(memory, prompt)

    ref = Ref({n: v.float() for n, v in weights.items()}, cfg)
    record = []
    ref_tokens, ref_scores = beam_search(ref, prompt, ref.quantized_cross(memory, sv["cross_kv_bits"]),
                                         sv["init_tokens"], sv["eot"], k, max_new, record=record)
    V = cfg["whisper"]["n_vocab"]
    margins = []  # the reference's k-th against (k+1)-th candidate, each step
    score = torch.full((b, k), -1e30)
    score[:, 0] = 0.0
    for logits, src, tok in record:
        assert src.shape == tok.shape == (b, k) and logits.shape == (b * k, V)
        cand = (score[..., None] + torch.log_softmax(logits, -1).reshape(b, k, V)).reshape(b, -1)
        top = cand.topk(k + 1, dim=-1).values
        margins.append(float((top[:, k - 1] - top[:, k]).min()))
        score = top[:, :k]
    assert min(margins) > 1e-3, margins
    assert torch.equal(tokens.long(), ref_tokens)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-4, atol=1e-4)


def test_tiny_beam_cell_is_correct():
    _, res, line = run_cell(tiny_cell(), SEED, trace=1)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"logit_err", "select_gap", "score_gap"}
    assert {"stage_ms_per_batch.decode", "search_ms_per_step.decode", "beam_mfu.decode",
            "beam_select_ms_per_step.decode"} <= set(line["metrics"])
    assert res.obs.batch_rows == 10 and res.detail["iterations"] == [6] * res.detail["batches"]


@pytest.mark.parametrize("fault", control_beam.FAULTS)
def test_tiny_beam_cell_with_a_fault_is_not_correct(fault):
    with control_beam.planted(fault, row=0, k=5):
        _, _, line = run_cell(tiny_cell(), SEED)
    assert not line["correct"], line["checks"]

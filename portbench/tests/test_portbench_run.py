"""A whole run of each cell, cut to a tiny size on the CPU, past the look
for a card: ``correct`` comes out true on the program as it is, and false
with the timed path broken underneath in each way the cell can break
(a token altered where it is produced, half of the batch's answers lost;
a step that leaves its state unchanged, half of the batch left out and the
mean taken over the rest). The full fine-tune's and the data-parallel
mixes are kept for later cells (``portbench/traffic``); the exchange
between ranks left out is run on two gloo ranks of the data-parallel mix."""

import pytest
import torch

from portbench.tests.tiny import run_cell, tiny_cell

SEED = 2**32 + 17


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def altered_tokens(monkeypatch, alter):
    from robustsq_whisper_torch.decode import search

    build = search.build_greedy_decoder

    def patched(dec, cfg, device="cuda"):
        run = build(dec, cfg, device)

        def broken(memory, spk_prompt):
            tokens, scores = run(memory, spk_prompt)
            return alter(tokens.clone(), cfg), scores
        return broken

    monkeypatch.setattr(search, "build_greedy_decoder", patched)


def test_decode_correct():
    _, _, line = run_cell(tiny_cell("qformer_medium.decode_greedy_b128"), SEED, trace=1)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert {"stage_ms_per_batch.decode", "search_ms_per_step.decode", "mfu.decode"} <= set(line["metrics"])


def _one_token(tokens, cfg):
    tokens[0, 1] = (tokens[0, 1] + 1) % 50257
    return tokens


def _half_answers(tokens, cfg):
    tokens[tokens.shape[0] // 2:] = cfg.eot
    return tokens


@pytest.mark.parametrize("alter", [_one_token, _half_answers], ids=["token-altered", "half-answers-lost"])
def test_decode_fault_is_not_correct(monkeypatch, alter):
    altered_tokens(monkeypatch, alter)
    _, _, line = run_cell(tiny_cell("qformer_medium.decode_greedy_b128"), SEED)
    assert not line["correct"], line["checks"]


TRAIN_CELLS = ["qformer_medium.train_full_b8", "embed_medium.train_lora_b8"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_correct(cell):
    _, res, line = run_cell(tiny_cell(cell), SEED)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and len(res.detail["setup_losses"]) == 3


def _unchanged_state(monkeypatch):
    from robustsq_whisper_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "_apply", lambda self, grads: None)


def _half_batch(monkeypatch):
    from robustsq_whisper_torch.models import ts_model

    forward = ts_model.TSASRModel.forward

    def half(self, batch, *args, **kw):
        h = batch["speech"].shape[0] // 2
        cut = {k: (v[:h, :h] if k == "neg_logits" else v[:h]) for k, v in batch.items()}
        return forward(self, cut, *args, **kw)

    monkeypatch.setattr(ts_model.TSASRModel, "forward", half)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch], ids=["state-unchanged", "half-batch"])
def test_training_fault_is_not_correct(monkeypatch, fault, cell):
    fault(monkeypatch)
    _, _, line = run_cell(tiny_cell(cell), SEED)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault,correct", [("none", True), ("no_exchange", False)])
def test_data_parallel_training_and_the_exchange_left_out(fault, correct):
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(here / "dp_worker.py"), str(SEED), fault],
        capture_output=True, text=True, timeout=600, cwd=str(here.parents[1]))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is correct, line["checks"]
    assert line["device"]["count"] == 2

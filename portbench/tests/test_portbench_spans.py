"""The six readers of the program's ``rsq:`` spans: their numbers on a
hand-made sub-window, nothing to read without one or without the spans,
and in the tiny decode and LoRA cells on the CPU a reading of each under
``--trace 1`` and none under ``--trace 0``."""

import math
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import run_cell, tiny_cell

SEED = 2**32 + 29
DECODE = ("token_step_host_ms.decode", "stop_wait_ms_per_step.decode", "token_loop_idle_share.decode")
TRAIN = ("forward_ms_per_step.train", "backward_ms_per_step.train", "optimizer_ms_per_step.train")
CELLS = {"qformer_medium.decode_greedy_b128": DECODE, "embed_medium.train_lora_b8": TRAIN}
# a window long enough for the tiny LoRA cell's profiled step (steps of
# about 4 s on the CPU); a tiny decode batch takes well under a second
SECONDS = {"qformer_medium.decode_greedy_b128": 1.0, "embed_medium.train_lora_b8": 8.0}


def read(name, obs):
    return harness.load_module("metrics", name).read(obs)


def observed(host_ops, device_ops=()):
    return SimpleNamespace(sub=SimpleNamespace(t1=1.0, host_ops=list(host_ops), device_ops=list(device_ops)))


# two token steps of 10 and 20 us, a stop check of 2 and 4 us inside each;
# the device busy over [5, 12) and [25, 40) (clipped to the steps: 7 + 5)
STEPS = [("rsq:decode.step", 0.0, 10.0), ("rsq:decode.stop_check", 6.0, 2.0),
         ("rsq:decode.step", 10.0, 20.0), ("rsq:decode.stop_check", 24.0, 4.0),
         ("aten::add", 1.0, 1.0), ("rsq:decode.search", -1.0, 50.0)]
BUSY = [("k", 5.0, 4.0), ("k", 8.0, 4.0), ("k", 25.0, 15.0)]
# two training steps of 100 and 120 us
TRAIN_OPS = [("rsq:train.step", 0.0, 100.0), ("rsq:train.forward", 5.0, 30.0),
             ("rsq:train.backward", 40.0, 40.0), ("rsq:train.optimizer", 82.0, 10.0),
             ("rsq:train.step", 100.0, 120.0), ("rsq:train.forward", 105.0, 40.0),
             ("rsq:train.backward", 150.0, 50.0), ("rsq:train.optimizer", 202.0, 12.0)]


@pytest.mark.parametrize("name,value", [
    ("token_step_host_ms.decode", ((10 - 2) + (20 - 4)) / 2 / 1e3),
    ("stop_wait_ms_per_step.decode", (2 + 4) / 2 / 1e3),
    ("token_loop_idle_share.decode", 100.0 * (1 - (7 + 5) / 30)),
    ("forward_ms_per_step.train", (30 + 40) / 2 / 1e3),
    ("backward_ms_per_step.train", (40 + 50) / 2 / 1e3),
    ("optimizer_ms_per_step.train", (10 + 12) / 2 / 1e3),
])
def test_reading_by_hand(name, value):
    assert read(name, observed(STEPS + TRAIN_OPS, BUSY)) == pytest.approx(value)


@pytest.mark.parametrize("name", DECODE + TRAIN)
def test_nothing_to_read(name):
    """No sub-window, one not stopped, or one without the spans (a program
    that opens none): nothing, and no error."""
    assert read(name, SimpleNamespace(sub=None)) is None
    unfinished = observed(STEPS + TRAIN_OPS, BUSY)
    unfinished.sub.t1 = None
    assert read(name, unfinished) is None
    assert read(name, observed([("aten::mm", 0.0, 5.0), ("pb:step", 0.0, 9.0)], BUSY)) is None


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(CELLS))
def test_tiny_cell_reports_its_span_metrics_traced_only(cell):
    names = CELLS[cell]
    _, res, line = run_cell(tiny_cell(cell), SEED, seconds=SECONDS[cell], trace=1)
    values = {n: line["metrics"][n]["value"] for n in names}
    assert all(math.isfinite(v) and v >= 0 for v in values.values()), values
    if names == DECODE:
        assert values["token_loop_idle_share.decode"] <= 100.0
    else:
        steps = [h for h in res.obs.sub.host_ops if h[0] == "rsq:train.step"]
        mean_step_ms = sum(d for _, _, d in steps) / 1e3 / len(steps)
        assert sum(values.values()) <= mean_step_ms
    _, _, untraced = run_cell(tiny_cell(cell), SEED, trace=0)
    assert not set(names) & set(untraced["metrics"])

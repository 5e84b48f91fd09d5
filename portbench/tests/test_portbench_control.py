"""The control fails where the program passes: at a size a test run holds,
the plain reference in the precision below the configuration's (fp8
operands) reads at least three times the program's numbers, on the CPU
(the kernels' plain versions) and on the card (the kernels)."""

import pytest
import torch

from portbench import control
from portbench.tests.tiny import run_cell, tiny_cell

SEED = 2**31 + 101


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield request.param
    torch.set_num_threads(n)


def width(device):
    return 128 if device == "cuda" else 64


def test_decode_control_reads_three_times_the_program(device):
    cell = tiny_cell("qformer_medium.decode_greedy_b128", width(device))
    _, _, line = run_cell(cell, SEED, device=device)
    assert line["correct"], line["checks"]
    ctl = control.decode_readings(cell, SEED, device)["control"]
    assert ctl["logit_err"] >= 3 * line["checks"]["logit_err"]["value"]
    assert ctl["logit_err"] > cell.limits["logit_err"]


@pytest.mark.parametrize("name", ["qformer_medium.train_full_b8", "embed_medium.train_lora_b8"])
def test_training_control_reads_three_times_the_program(device, name):
    cell = tiny_cell(name, width(device))
    _, _, line = run_cell(cell, SEED, device=device)
    assert line["correct"], line["checks"]
    ctl = control.train_readings(cell, SEED, device)["control"]
    assert any(ctl[k] >= 3 * line["checks"][k]["value"] and ctl[k] > cell.limits[k] for k in ctl)

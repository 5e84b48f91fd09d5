"""A cell of BENCHMARK.json cut to a tiny size for the CPU: the Whisper
blocks 64 wide and 2 deep, a small Qformer, short batches. The vocabulary
stays the full one (the special tokens sit at its end)."""

from __future__ import annotations

import copy
import json

from portbench import harness

TINY_TRAFFIC = {
    "decode_dataset": {"batch_size": 2, "enc_chunk": 1, "max_new_tokens": 6, "pool_batches": 2,
                       "check_utterances": 2},
    "run_training": {"batch_size": 2, "pool_batches": 4, "profile_steps": [1, 2]},
}
# limits of the tiny cells, above their CPU readings (program: logit_err
# ~0.007, gap 0; loss ~1e-4, grad ~0.005, change ~0.02) and below the faults'
TINY_LIMITS = {"logit_gap": 0.5, "logit_err": 0.05, "loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.1}


# the numbers each driver compares
DRIVER_LIMITS = {"decode_dataset": ("logit_gap", "logit_err"),
                 "run_training": ("loss_gap", "grad_gap", "change_gap")}


def cell_by_name(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json, or for ``<config>.<traffic>``
    that it does not list (a mix kept for a later cell) the two files."""
    names = {w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]}
    if name in names:
        return harness.load_cell(name)
    config, traffic = name.split(".", 1)
    bench = harness.BENCH_DIR
    traffic = json.loads((bench / "traffic" / f"{traffic}.json").read_text())
    return harness.Cell(name=name, chips=1, config=json.loads((bench / "configs" / f"{config}.json").read_text()),
                        traffic=traffic, end_to_end=[], per_layer=[],
                        limits=dict.fromkeys(DRIVER_LIMITS[traffic["driver"]]))


def tiny_cell(name: str, width: int = 64) -> harness.Cell:
    """``width`` 64 for the CPU; 128 (heads of 64, as the card's kernels
    take them) on the card."""
    cell = cell_by_name(name)
    c = copy.deepcopy(cell.config)
    c["whisper"].update(n_audio_state=width, n_audio_head=2, n_audio_layer=2, n_text_state=width,
                        n_text_head=2, n_text_layer=2)
    c["encoder"].update(num_query_tokens=4, qformer_hidden_size=32, qformer_heads=2,
                        qformer_intermediate_size=64)
    c["model"]["num_speakers"] = 50
    cell.config = c
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]]}
    cell.limits = {k: TINY_LIMITS[k] for k in cell.limits}
    return cell


def run_cell(cell: harness.Cell, seed: int, seconds: float = 1.0, trace: int = 0, device="cpu"):
    """One run of ``cell`` without the look for a card: (ctx, result, line)."""
    from portbench import run

    args = run.parse(["--workload", cell.name, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    ctx, res = run.run_here(cell, args, device)
    return ctx, res, run.result_line(cell, args, ctx, res, setup_s=1.0)

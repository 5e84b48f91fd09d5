"""Readings that set the limits of a beam cell's ``correct``
(``logit_err``, ``select_gap``, ``score_gap``; ``drivers/decode_beam.py``):

- ``sound``: the program's own numbers, one run a seed through the cell's
  driver with a window of a moment (the warm-up batch, window batch 0 and
  its check);
- ``control``: the plain reference with fp8 operands (the precision below
  the bf16 the configuration states) put in the program's place: its beam
  search (``reference/beam.py``) over the same sampled utterances, its
  logits and lineage checked as the program's are;
- the faults, each planted in the program for a run (``planted``):
  ``altered_token``, one served token altered; ``swapped_backpointer``, two
  rows of one utterance that come from different beams swapped in the
  first cache reorder of each batch that has such rows;
  ``kth_replaced``, the k-th candidate the selection keeps replaced by the
  (k+1)-th, at every step.

    python3 portbench/control_beam.py --workload <name> --sound 1,2,3 \\
        --control 4,5,6 --faults 7 [--out FILE]

One JSON line a reading on standard output; with ``--out`` all of them
and, under ``summary``, the largest sound and the least control and fault
reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, traffic as traffic_mod  # noqa: E402
from portbench.control import ctx_for  # noqa: E402
from portbench.drivers.decode_beam import beam_numbers, reference_tree  # noqa: E402
from portbench.drivers.decode_dataset import sample_rows  # noqa: E402
from portbench.reference.beam import beam_search  # noqa: E402
from portbench.reference.frontend import log_mel, pcm16  # noqa: E402
from portbench.reference.model import Ref, param_specs  # noqa: E402
from portbench.weights import make_weights  # noqa: E402

FAULTS = ("altered_token", "swapped_backpointer", "kth_replaced")
NUMBERS = ("logit_err", "select_gap", "score_gap")


@contextlib.contextmanager
def planted(name: str, row: int, k: int):
    """The program with fault ``name`` for the block; ``row``: the batch
    row (utterance) the first two faults hit; ``k``: the beams."""
    from robustsq_whisper_torch.decode import pipeline, search

    saved = []

    def patch(module, attr, value):
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    if name == "altered_token":
        build = pipeline.build_beam_decoder

        def altered(dec, cfg, device="cuda"):
            run = build(dec, cfg, device)

            def broken(memory, spk_prompt):
                tokens, scores = run(memory, spk_prompt)
                tokens = tokens.clone()
                tokens[row, 1] = (tokens[row, 1] + 1) % 50257
                return tokens, scores
            return broken

        patch(pipeline, "build_beam_decoder", altered)
    elif name == "swapped_backpointer":
        reorder = search.beam_reorder_cache
        state = {"live": None, "fired": False}

        def swapped(cache, src_rows, live=None, time_len=None):
            if state["live"] is None or live <= state["live"]:  # a new batch
                state["fired"] = False
            state["live"] = live
            if not state["fired"]:
                mine = src_rows[row * k:(row + 1) * k].tolist()
                other = next((j for j in range(1, k) if mine[j] != mine[0]), None)
                if other is not None:
                    src_rows = src_rows.clone()
                    src_rows[row * k], src_rows[row * k + other] = mine[other], mine[0]
                    state["fired"] = True
            return reorder(cache, src_rows, live=live, time_len=time_len)

        patch(search, "beam_reorder_cache", swapped)
    elif name == "kth_replaced":
        top = search.top_k_stable

        def kth_replaced(x, n):
            values, indices = top(x, n + 1)
            keep = list(range(n - 1)) + [n]
            return values[..., keep], indices[..., keep]

        patch(search, "top_k_stable", kth_replaced)
    else:
        raise ValueError(f"no fault {name!r}; the faults are {FAULTS}")
    try:
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)


def program_readings(cell, seed: int, device: str = "cuda") -> dict:
    """The cell's three numbers on the program, one window batch."""
    from portbench import run

    args = run.parse(["--workload", cell.name, "--seed", str(seed), "--seconds", "0.001", "--trace", "0"])
    _, res = run.run_here(cell, args, device)
    return {n: res.checks[n]["value"] for n in NUMBERS}


@torch.no_grad()
def control_readings(cell, seed: int, device: str = "cuda") -> dict:
    """The three numbers of the fp8 reference's beam search, put in the
    program's place over the cell's sampled utterances of batch 0."""
    ctx = ctx_for(cell, seed, device)
    cfg, tr, sv, dev = ctx.config, ctx.traffic, ctx.config["serving"], ctx.device
    pool = traffic_mod.decode_pool(tr, seed, dev)
    rows = sample_rows(tr["batch_size"], tr["check_utterances"], seed)
    P = {n: v.float() for n, v in make_weights(param_specs(cfg, heads=False), seed, dev).items()}
    ctl = Ref(P, cfg, lowp="fp8")
    n_mels = cfg["whisper"]["n_mels"]
    mel, ml = log_mel(torch.from_numpy(pcm16(pool["speech"][rows])).to(dev),
                      torch.from_numpy(pool["speech_lens"][rows]).long().to(dev), n_mels)
    emel, el = log_mel(torch.from_numpy(pcm16(pool["enroll"][rows])).to(dev),
                       torch.from_numpy(pool["enroll_lens"][rows]).long().to(dev), n_mels)
    memory, _, prompt, _ = ctl.encode(mel, ml, emel, el, approx=sv["gelu_approx"])
    cross = ctl.quantized_cross(memory, sv["cross_kv_bits"])
    k, eot = tr["beam_size"], sv["eot"]
    record = []
    tokens, _ = beam_search(ctl, prompt, cross, sv["init_tokens"], eot, k, tr["max_new_tokens"],
                            sv["stop_early"], record)
    u = len(rows)
    logits = torch.stack([r[0] for r in record]).view(len(record), u, k, -1)
    src = torch.stack([r[1] for r in record[:-1]]).view(-1, u, k).cpu() if len(record) > 1 else \
        torch.zeros((0, u, k), dtype=torch.long)
    tok = torch.stack([r[2] for r in record[:-1]]).view(-1, u, k).cpu() if len(record) > 1 else \
        torch.zeros((0, u, k), dtype=torch.long)
    served = [row[: row.index(eot)] if eot in row else row for row in tokens.tolist()]
    del ctl, P, cross, memory, record
    ref_logits, served_lp, _ = reference_tree(ctx, pool, rows, src.numpy(), tok.numpy(), served)
    return beam_numbers(ref_logits, logits, src, tok, served_lp, eot)


def fault_readings(cell, seed: int, name: str, device: str = "cuda") -> dict:
    tr = cell.traffic
    row = sample_rows(tr["batch_size"], tr["check_utterances"], seed)[0]
    with planted(name, row, tr["beam_size"]):
        return program_readings(cell, seed, device)


def seeds(text: str):
    return [int(x) for x in text.split(",")] if text else []


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    jobs = [("sound", s, lambda s: program_readings(cell, s)) for s in seeds(args.sound)]
    jobs += [("control", s, lambda s: control_readings(cell, s)) for s in seeds(args.control)]
    jobs += [(f, s, lambda s, f=f: fault_readings(cell, s, f)) for s in seeds(args.faults) for f in FAULTS]
    readings = []
    for kind, s, fn in jobs:
        t0 = time.perf_counter()
        values = fn(s)
        readings.append({"kind": kind, "seed": s, **values, "seconds": round(time.perf_counter() - t0, 1)})
        print(json.dumps({"workload": args.workload, **readings[-1]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for kind in ["sound", "control", *FAULTS]:
        mine = [r for r in readings if r["kind"] == kind]
        if mine:
            pick = max if kind == "sound" else min
            summary[kind] = {n: pick(r[n] for r in mine) for n in NUMBERS} | {"seeds": len(mine)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"readings": readings, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()

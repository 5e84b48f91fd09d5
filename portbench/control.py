"""Readings that set the limits of ``correct``: the plain reference put in
the program's place, in float32 (the sound side) and as the control (fp8
operands, the precision below the bf16 the configuration states), and the
faults a cell can have, planted in the reference. The benchmark's runs never
run this; it needs no program.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--out FILE]

Decode cells: the reference decodes the sampled utterances greedily itself;
``control`` holds the widest gap of the tokens the fp8 reference puts first
and the fp8 logits' worst RMS error, ``altered_token`` the gap of one served
token altered where it is produced.
Training cells: ``control`` is the three numbers of the fp8 reference's
three steps against the float32 reference's, ``half_batch`` those of a step
that takes half of each batch and the mean over the rest, and (on more than
one chip) ``no_exchange`` those of one rank's rows alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, traffic as traffic_mod  # noqa: E402
from portbench.reference.frontend import log_mel, pcm16  # noqa: E402
from portbench.reference.model import Ref, param_specs  # noqa: E402
from portbench.weights import make_weights  # noqa: E402


def ctx_for(cell, seed, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return SimpleNamespace(config=cell.config, traffic=cell.traffic, limits=cell.limits, seed=seed,
                           device=torch.device(device), world=1, rank=0)


@torch.no_grad()
def reference_greedy(ctx, pool, rows):
    """The float32 reference's own greedy tokens for pool ``rows`` (eot
    stripped), with the top-1 minus top-2 margin at each position."""
    cfg, dev, sv, tr = ctx.config, ctx.device, ctx.config["serving"], ctx.traffic
    P = {k: v.float() for k, v in make_weights(param_specs(cfg, heads=False), ctx.seed, dev).items()}
    ref = Ref(P, cfg)
    sp = torch.from_numpy(pcm16(pool["speech"][rows])).to(dev)
    er = torch.from_numpy(pcm16(pool["enroll"][rows])).to(dev)
    mel, ml = log_mel(sp, torch.from_numpy(pool["speech_lens"][rows]).long().to(dev), cfg["whisper"]["n_mels"])
    emel, el = log_mel(er, torch.from_numpy(pool["enroll_lens"][rows]).long().to(dev), cfg["whisper"]["n_mels"])
    memory, _, prompt, _ = ref.encode(mel, ml, emel, el, approx=sv["gelu_approx"])
    cross = ref.quantized_cross(memory, sv["cross_kv_bits"])
    seq = torch.tensor([sv["init_tokens"]] * len(rows), device=dev)
    done = torch.zeros(len(rows), dtype=torch.bool, device=dev)
    margins = []
    for _ in range(tr["max_new_tokens"]):
        x, _ = ref.embed_prefixed(seq, prompt)
        logits = ref.decode(x, cross=cross)[:, -1]
        top = logits.topk(2, -1)
        margins.append((top.values[:, 0] - top.values[:, 1]).cpu().numpy())
        nxt = torch.where(done, sv["eot"], top.indices[:, 0])
        done |= nxt == sv["eot"]
        seq = torch.cat([seq, nxt[:, None]], 1)
        if bool(done.all()):
            break
    toks = []
    for row in seq[:, len(sv["init_tokens"]):].tolist():
        toks.append(row[: row.index(sv["eot"])] if sv["eot"] in row else row)
    return toks, np.stack(margins, 1)


def decode_readings(cell, seed, device):
    from portbench.drivers.decode_dataset import (
        logit_err, reference_logits, sample_rows, served_with_eot, token_gap)

    ctx = ctx_for(cell, seed, device)
    pool = traffic_mod.decode_pool(ctx.traffic, seed, ctx.device)
    rows = sample_rows(ctx.traffic["batch_size"], ctx.traffic["check_utterances"], seed)
    toks, margins = reference_greedy(ctx, pool, rows)
    refs, ctls = reference_logits(ctx, pool, rows, toks, lowp="fp8")
    eot, max_new = ctx.config["serving"]["eot"], ctx.traffic["max_new_tokens"]
    altered = [list(t) for t in toks]
    pos = min(5, len(altered[0]) - 1)
    altered[0][pos] = (altered[0][pos] + 1) % 50257
    alt = torch.tensor(served_with_eot(altered[0], max_new, eot), device=ctx.device)
    return {"control": {"logit_gap": max(token_gap(r, c.argmax(-1)) for r, c in zip(refs, ctls)),
                        "logit_err": max(logit_err(c, r) for r, c in zip(refs, ctls))},
            "altered_token": {"logit_gap": token_gap(refs[0], alt)},
            "tokens": int(sum(len(r) for r in refs)),
            "min_margin": float(margins.min()), "median_margin": float(np.median(margins)),
            "first_tokens": toks[0][:12], "distinct_tokens_row0": len(set(toks[0]))}


def train_readings(cell, seed, device):
    from portbench.drivers.run_training import numbers, reference_steps

    ctx = ctx_for(cell, seed, device)
    pool = traffic_mod.train_pool(ctx.traffic, ctx.config, seed, ctx.device)
    base = reference_steps(ctx, pool)
    out = {"losses": base[0]}
    out["control"] = {k: v[0] for k, v in numbers(*reference_steps(ctx, pool, lowp="fp8"), *base).items()}
    b = ctx.traffic["batch_size"]
    half = [{k: v[: b // 2] if k != "neg_logits" else v[: b // 2, : b // 2] for k, v in batch.items()}
            for batch in pool]
    out["half_batch"] = {k: v[0] for k, v in numbers(*reference_steps(ctx, half), *base).items()}
    if cell.chips > 1:
        n = b // cell.chips
        one = [{k: v[:n] if k != "neg_logits" else v[:n, :n] for k, v in batch.items()} for batch in pool]
        out["no_exchange"] = {k: v[0] for k, v in numbers(*reference_steps(ctx, one), *base).items()}
    out["unchanged_state"] = {"change_gap": 1.0}
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    fn = decode_readings if cell.traffic["driver"] == "decode_dataset" else train_readings
    results = {}
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        results[s] = fn(cell, s, "cuda")
        results[s]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, "seed": s, **results[s]}), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

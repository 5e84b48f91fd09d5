#!/usr/bin/env python3
"""Time repeated transcribes of the dense-flat-cache serving paths at
Whisper-medium, with the port package found under ``--root``, so that two
trees of the port can be compared on one card.

    python3 time_transcribes.py [--root DIR] [--reps 7] [--out FILE]

``--root`` is the directory holding ``robustsq_whisper_torch/`` (this
checkout by default); the models, the synthetic input and the engine
settings are chip_smoke's medium ones (bf16, seeded random weights, 4 x
(30 s, 10 s) pairs, 32 new tokens at most, int4 cross K/V, stop_early).
Paths: greedy with ``prefill_quantized`` off and on, beam 5 with the eager
reorder and with ``defer_reorder=8``. Each path builds its engine, runs one
warm-up transcribe, then times ``--reps`` transcribes (host wall clock to a
``torch.cuda.synchronize()``). Then, last because the profiler slows later
host work, one transcribe of each path runs under ``torch.profiler``,
which counts the device kernels and the PyTorch operator calls it made
(counts that do not depend on the host's load, where the wall times do)
and sums the device time of every kernel and of the self-cache reads.
The last line is one JSON object: the package's path, the card's name and
power limit, and for each path its times and median in ms, those counts
and a hash of the transcribed texts. Needs one CUDA device; without one
it exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

PATHS = {
    "greedy": dict(),
    "greedy prefill_quantized": dict(prefill_quantized=True),
    "beam 5 eager": dict(beam_size=5),
    "beam 5 defer_reorder=8": dict(beam_size=5, defer_reorder=8),
}
BATCH, MAX_NEW = 4, 32


def op_counts(torch, fn, trace_path: str, self_kernels) -> dict:
    """Run ``fn`` once under torch.profiler; the device kernels it launched
    and the PyTorch operator calls it made, read from the chrome trace,
    the summed device ms of every kernel, and the device ms of the kernels
    whose names hold one of ``self_kernels``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    cats = [e.get("cat") for e in events]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    reads = {}
    for e in kernels:
        if any(k in e["name"] for k in self_kernels):
            reads[e["name"]] = reads.get(e["name"], 0.0) + e["dur"] / 1e3
    return dict(device_kernels=cats.count("kernel"), cpu_ops=cats.count("cpu_op"),
                kernel_ms=sum(e["dur"] for e in kernels) / 1e3, self_read_ms=reads)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args()

    import chip_smoke  # this script's directory: model, input and engine helpers
    import torch

    if not torch.cuda.is_available():
        print("time_transcribes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import robustsq_whisper_torch
    from robustsq_whisper_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    secs, _ = _build.build_all()
    chip_smoke.log(f"package {robustsq_whisper_torch.__file__}; kernel build {secs:.1f} s")
    _, enc, dec = chip_smoke.medium_models(torch, dev)
    items = chip_smoke.synthetic_pairs(BATCH, seed=0)
    record = {
        "package": os.path.dirname(robustsq_whisper_torch.__file__),
        "gpu": chip_smoke.gpu_info(), "reps": args.reps, "paths": {},
    }
    engines = {}
    for name, cfg in PATHS.items():
        engine = engines[name] = chip_smoke.engine_for(
            torch, dev, enc, dec, BATCH, MAX_NEW, **cfg
        )
        engine.warmup()
        texts = engine.transcribe(items)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            engine.transcribe(items)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        record["paths"][name] = dict(
            ms=times, median_ms=statistics.median(times),
            texts_sha1=hashlib.sha1("\n".join(texts).encode()).hexdigest(),
        )
        chip_smoke.log(f"{name}: median {statistics.median(times):.1f} ms of "
                       + " ".join(f"{t:.1f}" for t in times))
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "robustsq_whisper_torch", "_build", "time_transcribes_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for name, engine in engines.items():
        record["paths"][name].update(op_counts(
            torch, lambda: engine.transcribe(items), trace, chip_smoke.SELF_KERNELS
        ))
        chip_smoke.log(f"{name}: {record['paths'][name]}")
    os.remove(trace)
    line = json.dumps(record)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

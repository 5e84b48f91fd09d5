"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration file, traffic mix, driver, limits and per-layer
readers are found by name (``BENCHMARK.json``; ``portbench/configs``,
``traffic``, ``drivers``, ``limits``, ``metrics``). A one-GPU cell runs in
this process; a cell on more GPUs starts one process a GPU under
``torch.distributed.run`` (a free rendezvous port) and rank 0 hands its
result back through a file. The last lines on standard error are the numbers
compared with their limits; the last line on standard output is the result
JSON. Exits 2 without a result when the machine lacks the cards the cell
asks for, and 3 when a forbidden module (JAX, the JAX package) is loaded.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

T_START = harness.process_start_wall()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-result", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


class Ctx:
    """What a driver gets: the cell's files, the run's arguments and the
    device, and the few operations that differ between one process and a
    group of ranks."""

    def __init__(self, cell, args, device, world=1, rank=0, group=None):
        import torch

        from portbench import program

        self.torch, self.program = torch, program
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.world, self.rank, self.group = world, rank, group
        self.t_window = None

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def empty_cache(self):
        if self.cuda:
            self.torch.cuda.empty_cache()

    def memory_peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def window_started(self):
        self.t_window = time.time()

    def reference_mode(self):
        """float32 without TF32 for the reference."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def mesh(self):
        if self.world == 1:
            return None
        from robustsq_whisper_torch.parallel.mesh import make_mesh

        return make_mesh(self.world, 1)

    def agree(self, flag: bool) -> bool:
        """``flag`` on any rank (host-side group: no device sync)."""
        if self.world == 1:
            return flag
        t = self.torch.tensor([int(flag)])
        self.torch.distributed.all_reduce(t, op=self.torch.distributed.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def gather(self, obj):
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        self.torch.distributed.all_gather_object(out, obj, group=self.group)
        return out

    def gather_subwindow(self, obs):
        sub = obs.sub
        mine = (None if sub is None or sub.t1 is None else (sub.busy_s(), sub.window_s),
                self.memory_peak())
        every = self.gather(mine)
        self.peak_all = max(m for _, m in every)
        if sub is not None and sub.t1 is not None and all(r is not None for r, _ in every):
            obs.busy_s_ranks = [r[0] for r, _ in every]
            obs.window_s_ranks = [r[1] for r, _ in every]


def result_line(cell, args, ctx, res, setup_s: float) -> dict:
    """The contract's result object, ``checks`` last."""
    import torch

    obs = res.obs
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = harness.load_module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {**res.end_to_end, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    peak = getattr(ctx, "peak_all", None) or res.memory_peak
    device = harness.device_info(torch, ctx.cuda, ctx.world, peak)
    line = {"correct": harness.judged(res.checks) and res.failed == 0, "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics, "device": device}
    sub = obs.sub
    if args.trace and sub is not None and sub.t1 is not None:
        busy = getattr(obs, "busy_s_ranks", None) or [sub.busy_s()]
        window = getattr(obs, "window_s_ranks", None) or [sub.window_s]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = sum(window) / len(window)
        line["breakdown"] = sub.breakdown()
    line["detail"] = res.detail
    line["checks"] = res.checks
    return line


def run_here(cell, args, device, world=1, rank=0, group=None):
    driver = harness.load_module("drivers", cell.traffic["driver"])
    ctx = Ctx(cell, args, device, world, rank, group)
    res = driver.run(ctx)
    return ctx, res


def emit(line: dict) -> int:
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for text in harness.check_lines(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def worker(cell, args) -> int:
    """One rank under ``torch.distributed.run``; rank 0 writes the result."""
    import torch

    from robustsq_whisper_torch.parallel.mesh import init_distributed

    world = init_distributed()
    rank = torch.distributed.get_rank()
    group = torch.distributed.new_group(backend="gloo", timeout=datetime.timedelta(minutes=15))
    device = f"cuda:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    ctx, res = run_here(cell, args, device, world, rank, group)
    if rank == 0:
        line = result_line(cell, args, ctx, res, setup_s=0.0)
        line["window_started_wall"] = ctx.t_window
        line["forbidden"] = harness.forbidden_modules()
        with open(args.rank_result, "w") as f:
            json.dump(line, f)
    torch.distributed.barrier(group=group)
    torch.distributed.destroy_process_group()
    return 0


def launch_ranks(cell, args) -> int:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={cell.chips}", str(Path(__file__).resolve()),
               "--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), "--rank-result", path]
        proc = subprocess.run(cmd, stdout=sys.stderr, stderr=sys.stderr, cwd=str(ROOT))
        if proc.returncode != 0:
            print(f"ranks exited with {proc.returncode}", file=sys.stderr)
            return proc.returncode or 1
        with open(path) as f:
            line = json.load(f)
    finally:
        os.unlink(path)
    forbidden = line.pop("forbidden")
    if forbidden:
        print(f"forbidden modules loaded in rank 0: {forbidden}", file=sys.stderr)
        return 3
    started = line.pop("window_started_wall")
    if not args.trace:
        line["metrics"]["setup_s"]["value"] = started - T_START
    line["checks"] = line.pop("checks")
    return emit(line)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    if args.rank_result:
        return worker(cell, args)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        return launch_ranks(cell, args)
    ctx, res = run_here(cell, args, "cuda")
    return emit(result_line(cell, args, ctx, res, setup_s=ctx.t_window - T_START))


if __name__ == "__main__":
    sys.exit(main())

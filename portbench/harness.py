"""The benchmark's shared yardstick: the manifest and a cell's files, the
result line, the device description, the profiled sub-window and its
reduction to busy time and a breakdown, host-sync counting, and the
module guard.

Nothing here imports the program. Peaks are NVIDIA's data-sheet figures
for the H100 SXM at 700 W (dense bf16 tensor-core rate, HBM3 bandwidth);
the card's power limit is printed beside them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
FORBIDDEN = ("jax", "jaxlib", "flax", "robustsq_whisper_tpu")


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(manifest: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, layer


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic
    mix and limits read from their files."""
    manifest = manifest or _load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e, layer = cell_metrics(manifest, name)
    return Cell(
        name=name, chips=w["chips"],
        config=_load_json(ROOT / cfg_entry["file"]),
        traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=layer,
        limits=_load_json(BENCH_DIR / "limits" / f"{name}.json"),
    )


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def device_info(torch, cuda: bool, count: int, memory_peak: int) -> Dict[str, Any]:
    return {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": count,
        "memory_peak_bytes": int(memory_peak),
        "power_limit": power_limit() if cuda else "none",
        "peak_bf16_flops": PEAK_BF16_FLOPS,
        "peak_hbm_bytes_s": PEAK_HBM_BYTES_S,
    }


# ------------------------------------------------------------ the sub-window

class SubWindow:
    """A profiled stretch of a run: ``torch.profiler`` (host and device)
    and ``torch.cuda.set_sync_debug_mode("warn")`` between ``start`` and
    ``stop``; then ``device_ops`` and ``host_ops`` hold the stretch's
    operations (name, start us, duration us) from its chrome trace and
    ``syncs`` the host syncs counted."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None
        self.syncs = 0
        self._warn = None
        self.device_ops: List[Tuple[str, float, float]] = []
        self.host_ops: List[Tuple[str, float, float]] = []
        self.host_tid: List[Any] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._warn = warnings.catch_warnings(record=True)
        self._caught = self._warn.__enter__()
        warnings.simplefilter("always")
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.syncs = sum("synchroniz" in str(w.message) for w in self._caught)
        self._warn.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            rec = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                self.device_ops.append(rec)
            elif e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
                                  "user_annotation"):
                self.host_ops.append(rec)
                self.host_tid.append(e.get("tid"))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device_ops)) / 1e6

    def kernels(self, patterns) -> List[Tuple[str, float, float]]:
        """Device operations whose name contains any of ``patterns``."""
        return [e for e in self.device_ops if any(p in e[0] for p in patterns)]

    def breakdown(self) -> Dict[str, list]:
        """Top device operations by time, and the device's idle stretches
        summed by the benchmark span and the innermost host operation of
        the benchmark's thread that they fall in."""
        by_name: Dict[str, float] = {}
        for name, _, dur in self.device_ops:
            key = name[:96]
            by_name[key] = by_name.get(key, 0.0) + dur / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = union(self.device_ops)
        gaps = sorted(((a + b) / 2, b - a) for (_, a), (b, _) in zip(busy, busy[1:]) if b > a)
        marks = [i for i, h in enumerate(self.host_ops) if h[0].startswith("pb:")]
        main = self.host_tid[marks[0]] if marks else None
        ops = sorted((h for h, t in zip(self.host_ops, self.host_tid) if t == main),
                     key=lambda h: (h[1], -h[2]))
        idle: Dict[str, float] = {}
        stack: List[Tuple[str, float, float]] = []  # open operations, outermost first
        k = 0
        for mid, length in gaps:  # a sweep: ops of one thread nest
            while k < len(ops) and ops[k][1] <= mid:
                while stack and stack[-1][1] + stack[-1][2] < ops[k][1]:
                    stack.pop()
                stack.append(ops[k])
                k += 1
            while stack and stack[-1][1] + stack[-1][2] < mid:
                stack.pop()
            live = [h for h in stack if h[1] + h[2] >= mid]
            span = next((h[0][3:] for h in reversed(live) if h[0].startswith("pb:")), "no span")
            op = next((h[0] for h in reversed(live) if not h[0].startswith("pb:")), "python between ops")
            key = f"{span}: {op}"[:96]
            idle[key] = idle.get(key, 0.0) + length / 1e6
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps_top]}


class Marks:
    """The benchmark's spans as profiler ranges named ``pb:<name>``, opened
    and closed from hooks (on the thread that runs the program)."""

    def __init__(self, torch):
        self.torch = torch
        self.open_ranges: Dict[str, Any] = {}

    def open(self, name: str) -> None:
        rf = self.torch.autograd.profiler.record_function(f"pb:{name}")
        rf.__enter__()
        self.open_ranges[name] = rf

    def close(self, name: str) -> None:
        rf = self.open_ranges.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


def union(events) -> List[Tuple[float, float]]:
    """Merged [start, end) intervals (us) of ``events`` (name, ts, dur)."""
    iv = sorted((ts, ts + dur) for _, ts, dur in events)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


# ------------------------------------------------------------ the result

def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} {v['rule']} {v['limit']!r} ({v.get('over', '')})"
            for k, v in checks.items()]


def judged(checks: Dict[str, dict]) -> bool:
    """Every number within its limit (a missing number fails)."""
    ok = True
    for v in checks.values():
        x = v["value"]
        if x is None or x != x:
            ok = False
        elif v["rule"] == "at most":
            ok &= x <= v["limit"]
        else:
            ok &= x >= v["limit"]
    return ok

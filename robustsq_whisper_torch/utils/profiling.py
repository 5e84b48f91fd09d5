"""Profiling helpers: the JAX package's ``utils/profiling.py`` over
``torch.profiler``.

- ``trace``: a ``torch.profiler`` capture of the block (the CPU, and the
  card's kernels when one is present), written as a chrome trace under a
  directory passed in or set in ``RSQ_TRACE_DIR``; without one it does
  nothing;
- ``annotate``: a named region of the trace (``record_function``, and an
  NVTX range on the card);
- ``StepTimer``: EMA steps/s of a loop;
- ``op_stats`` / ``top_ops``: time and calls per event name from the newest
  trace, per profiled run (the device kernels by default);
- ``log_compile_time``: logs a callable's first call, up to a
  ``torch.cuda.synchronize()``, which takes in the kernels' build and first
  launch.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

import torch

logger = logging.getLogger("robustsq_whisper_torch.profiling")


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block into ``trace_dir/trace_<pid>_<ns>.json`` when a
    directory is given or set in ``RSQ_TRACE_DIR``."""
    trace_dir = trace_dir or os.environ.get("RSQ_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named trace region: ``record_function``, and an NVTX range when a
    card is present."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """EMA throughput tracker for the training loop."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._last: Optional[float] = None
        self.steps_per_sec: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.time()
        if self._last is not None:
            inst = 1.0 / max(now - self._last, 1e-9)
            self.steps_per_sec = (
                inst
                if self.steps_per_sec is None
                else self.ema * self.steps_per_sec + (1 - self.ema) * inst
            )
        self._last = now
        return self.steps_per_sec


def op_stats(
    trace_dir: str, runs: int = 1, category: str = "kernel"
) -> Dict[str, Dict[str, float]]:
    """``{name: {"ms": total_ms / runs, "count": calls / runs}}`` over the
    complete events of category ``category`` in the newest chrome trace
    under ``trace_dir`` (``trace``'s, or any ``export_chrome_trace``).
    ``"kernel"`` (the default) is the card's kernels, the counterpart of
    the JAX package's device-op lines; ``"cpu_op"`` the host's operators.
    ``runs`` divides the totals by the profiled iterations, so they read
    per run. Host events nest, so their sum can exceed the wall time."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no chrome trace (*.json) under {trace_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        events = json.load(f)["traceEvents"]
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"ms": 0.0, "count": 0.0})
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != category:
            continue
        rec = out[e["name"]]
        rec["ms"] += e.get("dur", 0.0) / 1e3 / max(runs, 1)
        rec["count"] += 1.0 / max(runs, 1)
    return dict(out)


def top_ops(stats: Dict[str, Dict[str, float]], n: int = 25) -> str:
    """Human-readable table of the ``n`` most expensive ops from
    :func:`op_stats`, sorted by total busy ms."""
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["ms"])[:n]
    return "\n".join(
        f"{r['ms']:9.2f} ms  x{r['count']:<6.0f} {name[:100]}"
        for name, r in rows
    )


def log_compile_time(name: str, fn: Callable) -> Callable:
    """Wrap a callable; log its first call's latency, to a
    ``torch.cuda.synchronize()`` when a card is present (the kernels'
    build and first launch)."""
    state: Dict[str, bool] = {"first": True}

    def wrapped(*args, **kwargs):
        if state["first"]:
            t0 = time.time()
            out = fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            logger.info("%s: first call (build) %.1fs", name, time.time() - t0)
            state["first"] = False
            return out
        return fn(*args, **kwargs)

    return wrapped

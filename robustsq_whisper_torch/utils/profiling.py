"""Profiling helpers: the JAX package's ``utils/profiling.py`` over
``torch.profiler``.

- ``trace``: a ``torch.profiler`` capture of the block (the CPU, and the
  card's kernels when one is present), written as a chrome trace under a
  directory passed in or set in ``RSQ_TRACE_DIR``; without one it does
  nothing;
- ``annotate``: a span of the program, named ``rsq:<layer>.<phase>``: a
  ``record_function`` range while a ``torch.profiler`` capture records, so
  it lands in the same trace and on the same clock as the card's kernels;
  otherwise one flag read and a shared null context.

The spans: ``decode/pipeline.py::decode_dataset`` opens
``rsq:decode.frontend`` (``audio/frontend.py::pcm16_log_mel`` opens
``rsq:decode.frontend_copy`` inside it, once a waveform batch),
``.encode``, ``.search`` and ``.consume`` a batch;
``decode/search.py``'s greedy and beam loops ``rsq:decode.prefill`` once
and ``rsq:decode.step`` an iteration, with ``rsq:decode.stop_check`` (the
host's read of the stop flag; greedy's may wait on the device there, see
``search.StopFlags``) and greedy's ``rsq:decode.graph_replay``
(``decode/step_graph.py``, one a replayed token step) inside it;
``train/step.py``'s step ``rsq:train.step`` with ``rsq:train.forward``,
``.backward`` and ``.optimizer`` inside it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import ContextManager, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


_OFF = contextlib.nullcontext()


def annotate(name: str) -> ContextManager:
    """A span ``name``: a ``record_function`` range while a
    ``torch.profiler`` capture records; else the one shared null context,
    after one read of the profiler's Python-side flag (no call into the
    profiler, no allocation)."""
    # the flag is process-wide and set by every torch.profiler capture; it
    # reads in 0.03 us on an H100 host's CPU against 0.15 us for
    # torch._C._autograd._profiler_enabled() (torch 2.11)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(name)

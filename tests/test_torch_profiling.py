"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``StepTimer`` over a scripted clock, ``trace`` / ``annotate`` through
``torch.profiler`` into a chrome trace, ``op_stats`` / ``top_ops`` over it
and ``log_compile_time``."""

import json
import logging

import pytest
import torch

from robustsq_whisper_tpu.utils import profiling as jprof
from robustsq_whisper_torch.utils import profiling as tprof

torch.set_num_threads(1)


def test_step_timer_matches_jax(monkeypatch):
    """The same EMA of steps/s as JAX's over the same clock readings."""
    clock = [10.0, 10.5, 10.75, 11.75, 11.8, 13.0]
    out = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        ticks = iter(clock)
        monkeypatch.setattr(mod.time, "time", lambda: next(ticks))
        timer = mod.StepTimer(ema=0.8)
        out[name] = [timer.tick() for _ in clock]
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and out["port"][1] == 2.0


def _work():
    a = torch.ones(64, 64)
    for _ in range(3):
        a = torch.mm(a, a) / 64


def test_trace_does_nothing_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("RSQ_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with tprof.trace():
        _work()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("from_env", [False, True], ids=["argument", "RSQ_TRACE_DIR"])
def test_trace_writes_an_annotated_chrome_trace(tmp_path, monkeypatch, from_env):
    out = tmp_path / "traces"
    if from_env:
        monkeypatch.setenv("RSQ_TRACE_DIR", str(out))
    with tprof.trace(None if from_env else str(out)):
        with tprof.annotate("decode_step"):
            _work()
    (path,) = out.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "decode_step" in names and "aten::mm" in names


def test_op_stats_and_top_ops(tmp_path):
    """Per-run time and calls per operator of the newest trace; the device
    kernels' category finds none on the CPU; ``top_ops`` formats the
    stats as the JAX package's does."""
    with tprof.trace(str(tmp_path)):
        _work()
    stats = tprof.op_stats(str(tmp_path), runs=3, category="cpu_op")
    assert stats["aten::mm"]["count"] == pytest.approx(1.0)
    assert stats["aten::mm"]["ms"] > 0
    assert tprof.op_stats(str(tmp_path)) == {}  # no device kernels here
    table = tprof.top_ops(stats, n=2)
    assert table == jprof.top_ops(stats, n=2) and len(table.splitlines()) == 2
    with pytest.raises(FileNotFoundError):
        tprof.op_stats(str(tmp_path / "missing"))


def test_log_compile_time_logs_the_first_call_once(caplog):
    calls = []
    fn = tprof.log_compile_time("step", lambda x: calls.append(x) or x + 1)
    with caplog.at_level(logging.INFO, logger="robustsq_whisper_torch.profiling"):
        assert fn(1) == 2 and fn(2) == 3
    assert calls == [1, 2]
    assert [r.getMessage().split(":")[0] for r in caplog.records] == ["step"]
    assert "first call" in caplog.records[0].getMessage()

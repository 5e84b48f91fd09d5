"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``trace`` / ``annotate`` through ``torch.profiler`` into a chrome trace and
``op_stats`` / ``top_ops`` over it. The program's spans are
``tests/test_torch_spans.py``'s."""

import json

import pytest
import torch

from robustsq_whisper_tpu.utils import profiling as jprof
from robustsq_whisper_torch.utils import profiling as tprof

torch.set_num_threads(1)


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


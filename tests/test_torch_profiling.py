"""The port's ``utils/profiling.py`` on the CPU: ``trace`` / ``annotate``
through ``torch.profiler`` into a chrome trace. The program's spans are
``tests/test_torch_spans.py``'s."""

import json

import pytest
import torch

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

"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: Path):
    """Top-level names of every absolute import of ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names |= {a.value.split(".")[0] for a in node.args[:1] if isinstance(a, ast.Constant)}
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "robustsq_whisper_torch" not in names and "portbench" not in names


def test_the_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.model, portbench.weights, portbench.traffic; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('robustsq_whisper_torch', 'jax', 'jaxlib', 'flax', 'robustsq_whisper_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(BENCH.parent), timeout=120)
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "robustsq_whisper_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]

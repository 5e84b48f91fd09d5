"""BENCHMARK.json keeps the benchmark's contract: names and units of the
allowed characters, every per-layer metric moving an end-to-end metric its
cells report, every cell reporting set-up, another end-to-end metric and a
per-layer one, and every file a cell names found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def reports(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return True if e2e_names is None else metric["moves"] in e2e_names


def test_top_level_and_entry_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_text_fields():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    names += [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]
    names += [r for c in M["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in M["workloads"]] + [c["why"] for c in M["configs"]]
    texts += [c["source"] for c in M["configs"]] + [m["layer"] for m in M["per_layer"]] + M["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_sources_bounds_and_run_length():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_chips_and_pairs():
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric(cell):
    e2e = [m["name"] for m in M["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if reports(m, cell, set(e2e))]
    assert layer


def test_each_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_metrics_of_one_layer_share_its_name():
    layers = {m["layer"] for m in M["per_layer"]}
    assert len({layer.lower() for layer in layers}) == len(layers)


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    w = {x["name"]: x for x in M["workloads"]}[cell]
    cfg = {c["name"]: c for c in M["configs"]}[w["config"]]
    bench = ROOT / M["paths"][0]
    assert cfg["file"].startswith(M["paths"][0] + "/") and (ROOT / cfg["file"]).is_file()
    config = json.loads((ROOT / cfg["file"]).read_text())
    assert config["name"] == cfg["name"] and config["reduced"] == cfg["reduced"]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
    assert json.loads((bench / "limits" / f"{cell}.json").read_text())
    for m in M["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


def test_paths_and_command():
    assert M["command"][:2] == ["python3", "portbench/run.py"] and len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024

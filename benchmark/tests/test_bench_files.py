"""Every file the benchmark finds by name is there and parses, and
BENCHMARK.json keeps to the shape the harness reads."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = H.cell(workload)
    assert cell.chips == 1
    assert (H.BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert set(cell.data["limits"]) and all(v >= 0 for v in cell.data["limits"].values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(H.reader(metric["name"]).read)
        assert metric["moves"] in names


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_parses_and_is_used(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(conf["why"]) <= 200 and "\n" not in conf["why"] and "\t" not in conf["why"]
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert "assumed" in data and data["dtype"] == "float32"
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(layer) <= 200 for layer in layers)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_each_traffic_file_names_a_driver(path):
    traffic = json.loads(path.read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()

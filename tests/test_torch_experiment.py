"""The port's experiment sweep (magics_tpu_torch/scripts/run_experiment.py)
against the JAX script (scripts/run_experiment.py) on the CPU, over a
scenario directory of JSON documents (tests/torch_scenarios.py).

Both `main`s run in this process, in float64: the JAX script has no dtype
flag, so each module's `Simulator` name, which `main` imports at call time,
is patched to its package's Simulator with dtype float64. The JAX script is
not given `--platform` (the conftest has put JAX on the CPU); the port's
runs with `--platform cpu`. Rows equal but `wall_s`, exports within
test_torch_sim._compare's 1e-6 (integers exact), the same file names, the
same parsed flags but the two the port changes.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
from test_torch_sim import _compare
from torch_scenarios import write_scenario

import magics_tpu.analysis
import magics_tpu.sim.simulator
import magics_tpu_torch.analysis
import magics_tpu_torch.sim.simulator
from magics_tpu.config.schema import config_to_toml as jax_toml
from magics_tpu_torch.config.schema import config_to_toml as port_toml
from magics_tpu_torch.scripts import run_experiment as TX
from scripts import run_experiment as JX

REPO = Path(__file__).resolve().parents[1]
SCENARIO = "Crossing Lines"
PORT = ["--platform", "cpu"]
# the two flags the port changes: where it runs, and the scenario directory
# it reads by default (the JAX one is the reference's own, not in the repo)
CHANGED = {"platform", "scenarios_dir"}


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenarios")
    write_scenario(root, SCENARIO, max_time=3.0)
    return root


class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch) -> dict:
    """The namespace `main(argv)` parses, taken from its parser's
    parse_args before anything else runs."""
    real = argparse.ArgumentParser.parse_args
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main(argv)
    return vars(seen["args"])


def test_parsed_flags_equal_jax(monkeypatch):
    """Every shared flag parses to the same default and the same value;
    the port's two changes are its own."""
    jax_default = _parsed(JX.main, [SCENARIO], monkeypatch)
    port_default = _parsed(TX.main, [SCENARIO], monkeypatch)
    assert jax_default.keys() == port_default.keys()
    for key in jax_default.keys() - CHANGED:
        assert port_default[key] == jax_default[key], key
    assert port_default["scenarios_dir"] == "./config/scenarios"
    assert port_default["platform"] == "cuda"
    argv = [SCENARIO, "--scenarios-dir", "d", "--seeds", "1,2", "--robots", "5:15:5",
            "--max-time", "7.5", "--failure-rates", "0.0,0.7", "--target-speeds", "10,15",
            "--schedules", "centered", "--internals", "5,8", "--externals", "2",
            "--comms-radii", "20,40", "--tracking", "true,false", "--sigma-trackings", "0.1",
            "--preplan", "--out", "o"]
    jax_args = _parsed(JX.main, argv, monkeypatch)
    port_args = _parsed(TX.main, argv, monkeypatch)
    assert {k: v for k, v in port_args.items() if k != "platform"} == {
        k: v for k, v in jax_args.items() if k != "platform"}


def _fake_simulator(calls: list, package_toml):
    """A Simulator that runs nothing: it records what it was built from and
    the path it exported to."""

    class Fake:
        def __init__(self, sc, *, seed, max_sim_time, viz_log, inflight_planning, **extra):
            calls.append({"config": package_toml(sc.config), "seed": seed,
                          "formations": [dataclasses.asdict(f) for f in sc.formations.formations],
                          "max_sim_time": max_sim_time, "viz_log": viz_log,
                          "inflight_planning": inflight_planning})
            self.specs = [None] * 3
            self.stats = types.SimpleNamespace(captures=[])

        def run(self):
            return {"ticks": 7, "makespan": 0.7, "completed": 2}

        def export(self, path):
            calls[-1]["export"] = Path(path).name
            return {}

    return Fake


def test_sweep_order_overrides_tags_and_rows_equal_jax(scenarios, tmp_path, monkeypatch,
                                                       capsys):
    """Every axis swept at once, with Simulators that run nothing: the
    cells come in the same order, each scenario is overridden alike (its
    config's TOML and its formations), each export has the same file name
    and each row the same keys and values but wall_s."""
    argv = [SCENARIO, "--scenarios-dir", str(scenarios), "--seeds", "0,31",
            "--robots", "5:10:5", "--failure-rates", "0.0,0.7", "--target-speeds", "10,15",
            "--schedules", "interleave-evenly,centered", "--internals", "5,8",
            "--externals", "2", "--comms-radii", "20,40", "--tracking", "true,false",
            "--sigma-trackings", "0.1", "--max-time", "7", "--preplan"]
    fake = {"analyse": lambda export: {"per_robot": [1], "makespan": 0.7}}
    jax_calls, port_calls = [], []
    monkeypatch.setattr(magics_tpu.sim.simulator, "Simulator",
                        _fake_simulator(jax_calls, jax_toml))
    monkeypatch.setattr(magics_tpu_torch.sim.simulator, "Simulator",
                        _fake_simulator(port_calls, port_toml))
    monkeypatch.setattr(magics_tpu.analysis, "analyse", fake["analyse"])
    monkeypatch.setattr(magics_tpu_torch.analysis, "analyse", fake["analyse"])
    assert JX.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert TX.main(argv + PORT + ["--out", str(tmp_path / "port")]) == 0
    capsys.readouterr()
    assert len(port_calls) == 2 * 2 * 2 * 2 * 2 * 2 * 2 * 2 == len(jax_calls)
    for i, (want, got) in enumerate(zip(jax_calls, port_calls)):
        assert got == want, i
    jax_rows = json.loads((tmp_path / "jax" / "summary.json").read_text())
    port_rows = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert len({json.dumps(r["robots"]) + r["schedule"] for r in port_rows}) == 4
    for want, got in zip(jax_rows, port_rows, strict=True):
        assert list(got) == list(want)
        want.pop("wall_s"), got.pop("wall_s")
        assert got == want


@pytest.fixture(scope="module")
def runs(scenarios, tmp_path_factory):
    """Both sweeps for real, float64: 2 seeds x tracking off / on."""
    out = tmp_path_factory.mktemp("runs")
    argv = [SCENARIO, "--scenarios-dir", str(scenarios), "--seeds", "0,31",
            "--tracking", "false,true", "--max-time", "3"]
    seen = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(magics_tpu.sim.simulator, "Simulator",
                  functools.partial(magics_tpu.sim.simulator.Simulator, dtype=jnp.float64))
        m.setattr(magics_tpu_torch.sim.simulator, "Simulator",
                  functools.partial(magics_tpu_torch.sim.simulator.Simulator,
                                    dtype=torch.float64))
        assert JX.main(argv + ["--out", str(out / "jax")]) == 0
        assert TX.main(argv + PORT + ["--out", str(out / "port")], on_row=seen.append) == 0
    return {"jax": out / "jax", "port": out / "port", "seen": seen}


def test_rows_equal_jax(runs):
    """summary.json: the same rows in the same order, each within 1e-6
    but wall_s (integers exact); the Simulators ran in float64 on the CPU."""
    jax_rows = json.loads((runs["jax"] / "summary.json").read_text())
    port_rows = json.loads((runs["port"] / "summary.json").read_text())
    assert len(port_rows) == 4
    assert [r["tracking"] for r in port_rows] == [False, False, True, True]
    assert [r["seed"] for r in port_rows] == [0, 31, 0, 31]
    assert all(r["ticks"] == 30 and r["robots"] == 8 for r in port_rows)
    for want, got in zip(jax_rows, port_rows, strict=True):
        assert isinstance(got.pop("wall_s"), float)
        want.pop("wall_s")
        _compare(want, got, "row")
    for done in runs["seen"]:
        assert done.sim.state.pos.dtype == torch.float64
        assert done.sim.state.device.type == "cpu"
        assert done.times["capture_s"] == 0.0 and done.times["run_s"] > 0.0
        assert not done.sim.stats.captures


def test_exports_equal_jax(runs):
    names = sorted(p.name for p in runs["port"].glob("export_*.json"))
    assert names == sorted(p.name for p in runs["jax"].glob("export_*.json"))
    assert names == [f"export_Crossing-Lines_rcfg_t{t}_s{s}.json"
                     for t in (0, 1) for s in (0, 31)]
    for name in names:
        want = json.loads((runs["jax"] / name).read_text())
        got = json.loads((runs["port"] / name).read_text())
        assert got["config"] == want["config"]
        assert "viz" not in got and len(got["robots"]) == 8
        _compare(want, got, name)


def test_a_json_scenario_run_loads_no_yaml_and_reads_no_reference(tmp_path, monkeypatch):
    """The port's sweep in a fresh interpreter, from a directory holding
    config/scenarios, with no --scenarios-dir: it reads the scenario
    there; it loads neither PyYAML nor anything of JAX; it opens nothing
    under the root of the JAX script's default scenario directory."""
    jax_dir = Path(_parsed(JX.main, [SCENARIO], monkeypatch)["scenarios_dir"])
    forbidden = str(jax_dir.parents[1])
    write_scenario(tmp_path / "config" / "scenarios", SCENARIO, max_time=0.5)
    code = (
        "import sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "from magics_tpu_torch.scripts import run_experiment\n"
        f"assert run_experiment.main([{SCENARIO!r}, '--seeds', '5', '--platform', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        "for f in ('yaml', 'jax', 'magics_tpu')))\n"
        "assert not bad, bad\n"
        f"assert not [p for p in opened if p.startswith({forbidden!r})], opened\n"
        "assert any('config/scenarios' in p and p.endswith('config.toml') for p in opened)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads((tmp_path / "experiment-out" / "summary.json").read_text())
    assert [(r["robots"], r["seed"], r["ticks"]) for r in rows] == [(8, 5, 5)]
    assert (tmp_path / "experiment-out" / "export_Crossing-Lines_rcfg_s5.json").exists()

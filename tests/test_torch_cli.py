"""The port's CLI (magics_tpu_torch/cli.py) against the JAX package's
(magics_tpu/cli.py) on the CPU, over scenario directories written into a
temporary directory as JSON documents (tests/torch_scenarios.py).

Both CLIs run in this process: pytest's conftest has already put JAX on the
CPU with x64 on, so `--dtype f64` flips nothing (the JAX CLI is not given
`--platform`, which would update JAX's config); the port's CLI is given
`--platform cpu`. Tolerances: run summaries and REPL status lines equal;
exports within test_torch_sim._compare's 1e-6; texts the CLIs print equal
character for character.

Two of the JAX CLI's defects (ROADMAP F4) are not copied, each held here:
after a REPL `load`, the end-of-run outputs describe the new scenario and
the session's dtype is kept; and stepping (`Simulator.advance`) runs exactly
the ticks asked for.
"""

from __future__ import annotations

import io
import json
import sys

import pytest
import torch
from test_torch_sim import _compare
from torch_scenarios import write_scenario

from magics_tpu import cli as JCLI
from magics_tpu_torch import cli as TCLI
from magics_tpu_torch.io import checkpoint

CROSSING = "Crossing Lines"
SECOND = "Second Crossing"
PORT = ["--platform", "cpu"]


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenarios")
    write_scenario(root, CROSSING)
    write_scenario(root, SECOND, robots=6, seed=5, max_time=3.0, tile=60.0)
    (root / "not-a-scenario").mkdir()
    return root


def _run(main, argv, capsys, stdin: str | None = None):
    """stdout and stderr of `main(argv)` (its REPL reading `stdin`)."""
    if stdin is not None:
        old, sys.stdin = sys.stdin, io.StringIO(stdin)
    try:
        assert main(argv) == 0
    finally:
        if stdin is not None:
            sys.stdin = old
    out = capsys.readouterr()
    return out.out, out.err


def _summary(stdout: str) -> dict:
    line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
    summary = json.loads(line)
    summary.pop("wall_s")
    return summary


def _statuses(stderr: str) -> list[dict]:
    return [json.loads(ln) for ln in stderr.splitlines() if ln.startswith("{")]


def test_run_summary_and_export_equal_jax(scenarios, tmp_path, capsys):
    """A float64 run of the crossing to its max time: the summary line
    equal, the export within 1e-6, the checkpoints and snapshots of both."""
    scenario = str(scenarios / CROSSING)
    common = ["-i", scenario, "--dtype", "f64", "--quiet"]
    jout, _ = _run(JCLI.main, common + ["--export", str(tmp_path / "jax.json")], capsys)
    tout, _ = _run(TCLI.main, common + PORT + [
        "--export", str(tmp_path / "port.json"), "--checkpoint", str(tmp_path / "c.npz"),
        "--save-settings", str(tmp_path / "saved.toml")], capsys)
    summary = _summary(tout)
    assert summary == _summary(jout)
    assert summary["ticks"] == 40 and summary["robots"] == 8
    jexp = json.loads((tmp_path / "jax.json").read_text())
    texp = json.loads((tmp_path / "port.json").read_text())
    assert texp["scenario"] == CROSSING and len(texp["robots"]) == 8
    _compare(jexp, texp)
    assert (tmp_path / "c.npz").exists() and (tmp_path / "saved.toml").exists()


def test_resume_continues_from_the_checkpoint(scenarios, tmp_path, capsys):
    """--resume from a mid-run checkpoint of the REPL, then run to the max
    time: the same summary as the uninterrupted run."""
    scenario = str(scenarios / CROSSING)
    ckpt = tmp_path / "mid.npz"
    _run(TCLI.main, ["-i", scenario, "--quiet", "--interactive"] + PORT, capsys,
         stdin=f"step 17\ncheckpoint {ckpt}\nquit\n")
    whole, _ = _run(TCLI.main, ["-i", scenario, "--quiet"] + PORT, capsys)
    resumed, _ = _run(TCLI.main, ["-i", scenario, "--quiet", "--resume", str(ckpt)] + PORT,
                      capsys)
    assert _summary(resumed) == _summary(whole)


TEXT_ARGS = (
    [["--dump-default", kind] for kind in ("config", "formation", "environment")]
    + [["--dump-environment", name] for name in TCLI._ENVIRONMENTS]
    + [["--schedule-graph"], ["--list-scenarios"], ["-i", CROSSING, "--dump-schedule"]]
)


@pytest.mark.parametrize("args", TEXT_ARGS, ids=lambda a: "-".join(a).lstrip("-"))
def test_printed_texts_equal_jax(args, scenarios, capsys):
    argv = args + ["--scenarios-dir", str(scenarios)]
    jout, _ = _run(JCLI.main, argv, capsys)
    tout, _ = _run(TCLI.main, argv, capsys)
    assert tout == jout and tout.strip()


def test_texts_needing_pyyaml_raise_without_it(scenarios, monkeypatch):
    """Without PyYAML (the card's machine) a JSON scenario still loads,
    while --dump-environment and a YAML text that is not JSON raise an
    ImportError that names PyYAML."""
    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.env.model import load_yaml

    monkeypatch.setitem(sys.modules, "yaml", None)
    assert load_scenario(scenarios / CROSSING).environment.obstacles
    with pytest.raises(ImportError, match="PyYAML"):
        load_yaml("tiles: {grid: []}\n")
    with pytest.raises(ImportError):
        TCLI.main(["--dump-environment", "circle"])


def test_json_scenario_files_load_equal_in_both_packages(scenarios):
    """The JSON files load to equal scenarios in both packages; the float
    1e-05 is written as 1.0e-05, which PyYAML's YAML 1.1 reads as a float
    (`json.dumps` writes 1e-05, a string there)."""
    import yaml
    from test_torch_imports import _plain

    from magics_tpu.config.loader import load_scenario as jload
    from magics_tpu_torch.config.dump import json_yaml
    from magics_tpu_torch.config.loader import load_scenario as tload

    assert yaml.safe_load(json.dumps(1e-05)) == "1e-05"
    assert json_yaml([1e-05, 1e20, 0.5, 3]) == "[1.0e-05, 1.0e+20, 0.5, 3]"
    text = (scenarios / CROSSING / "environment.yaml").read_text()
    assert "1.0e-05" in text and json.loads(text) == yaml.safe_load(text)
    for name in (CROSSING, SECOND):
        j, t = jload(scenarios / name), tload(scenarios / name)
        assert t.environment.obstacles[0].rotation == 1e-05
        for part in ("config", "environment", "formations"):
            assert _plain(getattr(t, part)) == _plain(getattr(j, part)), (name, part)


REPL = "step 3\nstatus\nstep 3\nrun 0.3\nstatus\nbogus\nreset\nstatus\nstep 3\nquit\n"


def test_repl_statuses_equal_jax(scenarios, capsys):
    """The same REPL transcript through both CLIs: every status line and
    the final summary equal."""
    argv = ["-i", str(scenarios / CROSSING), "--dtype", "f64", "--quiet", "--interactive"]
    jout, jerr = _run(JCLI.main, argv, capsys, stdin=REPL)
    tout, terr = _run(TCLI.main, argv + PORT, capsys, stdin=REPL)
    statuses = _statuses(terr)
    assert [s["ticks"] for s in statuses] == [3, 9, 0]
    assert statuses == _statuses(jerr)
    assert _summary(tout) == _summary(jout) and _summary(tout)["ticks"] == 3
    assert "unknown command: bogus" in terr


def test_repl_load_ends_on_the_new_scenario_with_the_session_dtype(scenarios, tmp_path,
                                                                   capsys):
    """ROADMAP F4: after `load`, --export, --checkpoint, --snapshot and
    --player describe the new scenario (the JAX CLI's describe the old one),
    and the new Simulator keeps the session's dtype and device (the JAX
    CLI's drops --dtype)."""
    out = {k: tmp_path / f"out.{k}" for k in ("json", "npz", "png", "html")}
    argv = ["-i", CROSSING, "--scenarios-dir", str(scenarios), "--dtype", "f64", "--quiet",
            "--interactive", "--export", str(out["json"]), "--checkpoint", str(out["npz"]),
            "--snapshot", str(out["png"]), "--player", str(out["html"])] + PORT
    mid = {k: tmp_path / f"mid.{k}" for k in ("json", "png")}
    sys.stdin, old = io.StringIO(
        f"step 2\nload {SECOND}\nstatus\nstep 4\nexport {mid['json']}\nsnapshot {mid['png']}\n"
        "quit\n"), sys.stdin
    try:
        code, sim = TCLI.session(argv)
    finally:
        sys.stdin = old
    _, err = capsys.readouterr()
    assert code == 0 and f"loaded scenario: {SECOND}" in err
    assert sim.scenario.name == SECOND and len(sim.specs) == 6
    assert sim.state.pos.dtype == torch.float64 and sim.device.type == "cpu"
    assert [(s["robots"], s["ticks"]) for s in _statuses(err)] == [(6, 0)]
    export = json.loads(out["json"].read_text())
    assert export["scenario"] == SECOND and len(export["robots"]) == 6
    assert export["makespan"] == pytest.approx(0.4)
    state, meta = checkpoint.load(out["npz"], params=sim.params, device="cpu")
    assert meta["scenario"] == SECOND and int(state.tick) == 4
    assert state.pos.dtype == torch.float64 and state.pos.shape == (6, 2)
    assert f"magics_tpu — {SECOND}" in out["html"].read_text()
    assert out["png"].read_bytes() == mid["png"].read_bytes()
    assert json.loads(mid["json"].read_text()) == export


def test_repl_steps_run_exactly_the_ticks_asked(scenarios, capsys):
    """Stepping runs exactly n ticks, as chunks of at most the session's
    size (100): step 150 is one chunk of 100 and one of 50, after which the
    robots run on although the scenario's max time (4 s) has passed; `run`
    stops at the max time. On the CPU every chunk runs eagerly and nothing
    is captured (the card's test holds the capture count)."""
    argv = ["-i", str(scenarios / CROSSING), "--quiet", "--interactive"] + PORT
    sys.stdin, old = io.StringIO(
        "step 1\nstatus\nstep 3\nstatus\nstep 5\nstatus\nrun\nstatus\nstep 150\nstatus\n"
        "quit\n"), sys.stdin
    try:
        code, sim = TCLI.session(argv)
    finally:
        sys.stdin = old
    _, err = capsys.readouterr()
    assert code == 0
    assert [s["ticks"] for s in _statuses(err)] == [1, 4, 9, 40, 190]
    assert sim.stats.captures == [] and sim.graphs == {}
    # 1 + 1 + 1 chunks of the steps, run's chunk of 31, 100 + 50 of step 150
    assert sim.stats.eager_chunks == 6


def test_advance_zero_runs_no_tick(scenarios):
    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.sim.simulator import Simulator

    sim = Simulator(load_scenario(scenarios / CROSSING), device="cpu")
    assert sim.advance(0)["ticks"] == 0 and sim.stats.eager_chunks == 0


def test_the_cli_runs_on_the_card_unless_asked_for_the_cpu(scenarios):
    """--platform defaults to the card: without one the run raises, it does
    not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        TCLI.main(["-i", str(scenarios / CROSSING), "--quiet"])


def test_profile_writes_a_torch_profiler_trace(scenarios, tmp_path, capsys):
    trace = tmp_path / "prof"
    _run(TCLI.main, ["-i", str(scenarios / CROSSING), "--quiet", "--max-time", "0.3",
                     "--profile", str(trace)] + PORT, capsys)
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_entry_runs_one_tick():
    """entry() (the counterpart of __graft_entry__.entry) on the CPU: one
    tick of the 8-robot circle, its state finite and one tick on; on the
    card by default, so without one it raises."""
    from magics_tpu_torch.entry import entry

    fn, (state, sdf) = entry(device="cpu")
    out = fn(state, sdf)
    assert int(out.tick) == int(state.tick) + 1 and out.pos.shape == (8, 2)
    assert all(bool(torch.isfinite(x).all()) for x in (out.pos, out.belief_mean))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry()

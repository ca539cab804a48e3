"""The port stands alone: no module of magics_tpu_torch, nor chip_smoke.py,
imports JAX or anything of the JAX package (an AST scan of every import
statement, and the imports run in a fresh interpreter, which also loads no
PyYAML: the card's machine has none); the port's own copies of the
framework-free modules (core, env, config, io.metrics, analysis, the global
planner) behave as the JAX package's on the same inputs; and the entry
points build on the card by default, so without one they raise."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from magics_tpu.core import constants as JC
from magics_tpu.core import schedule as JS
from magics_tpu.core import timesteps as JTS
from magics_tpu_torch.core import constants as TC
from magics_tpu_torch.core import schedule as TS
from magics_tpu_torch.core import timesteps as TTS

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "magics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "magics_tpu")


def _imported(path: Path) -> set[str]:
    """Every module an import statement of `path` names (absolute imports;
    relative ones stay inside the port)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = sorted(n for n in _imported(path) if _forbidden(n))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_tests_or_the_jax_scripts(path):
    """The port's harnesses (magics_tpu_torch/scripts/) keep their own
    copies of what they take from scripts/ and tests/, which import JAX."""
    local = ("tests", "scripts")
    bad = sorted(n for n in _imported(path)
                 if any(n == f or n.startswith(f + ".") for f in local))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\ndef f():\n    from magics_tpu.core.schedule import ScheduleKind\n"
                   "    import jax.numpy as jnp\n")
    assert sorted(n for n in _imported(src) if _forbidden(n)) == [
        "jax.numpy", "magics_tpu.core.schedule"]
    assert not _forbidden("magics_tpu_torch.core.schedule")


def test_imports_load_no_jax_package():
    """Every module of the port and every module chip_smoke.py names, in a
    fresh interpreter: nothing of JAX or of magics_tpu ends in sys.modules,
    nor PyYAML or Pillow, which the card's machine lacks."""
    port = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES if p.name != "chip_smoke.py"
    )
    smoke = sorted(_imported(REPO / "chip_smoke.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {port + smoke!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN + ('yaml', 'PIL')!r}))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    for module in ("magics_tpu_torch.kernels.gbp_slot", "magics_tpu_torch.graph.grid",
                   "magics_tpu_torch.graph.chunk", "magics_tpu_torch.bench.scale",
                   "magics_tpu_torch.bench.headline", "magics_tpu_torch.sim.simulator",
                   "magics_tpu_torch.planner.mission", "magics_tpu_torch.io.checkpoint",
                   "magics_tpu_torch.config.dump", "magics_tpu_torch.env.sdf",
                   "magics_tpu_torch.analysis", "magics_tpu_torch.cli",
                   "magics_tpu_torch.entry", "magics_tpu_torch.core.pretty",
                   "magics_tpu_torch.core.gaussian", "magics_tpu_torch.viz.live",
                   "magics_tpu_torch.viz.render", "magics_tpu_torch.viz.player",
                   "magics_tpu_torch.viz.graphviz", "magics_tpu_torch.viz.png",
                   "magics_tpu_torch.parallel.comm", "magics_tpu_torch.parallel.shard_tick",
                   "magics_tpu_torch.parallel.launch", "magics_tpu_torch.bench.multichip_cost",
                   "magics_tpu_torch.bench.profile_tick", "magics_tpu_torch.bench.profile_slot",
                   "magics_tpu_torch.bench.micro_ablate",
                   "magics_tpu_torch.scripts.run_experiment",
                   "magics_tpu_torch.scripts.parity_rmse"):
        assert module in port, module


def test_cli_run_over_json_scenario_loads_no_yaml_or_pil(tmp_path):
    """A CLI run in a fresh interpreter over a scenario directory of JSON
    documents, writing an export, a snapshot PNG, a player and a frame
    sequence, loads neither PyYAML nor Pillow (nor anything of JAX)."""
    import json

    sys.path.insert(0, str(REPO / "tests"))
    from torch_scenarios import write_scenario

    scenario = write_scenario(tmp_path, "Crossing Lines", max_time=0.5)
    out = {k: str(tmp_path / f"out.{k}") for k in ("json", "png", "html")}
    code = (
        "import sys\n"
        "from magics_tpu_torch import cli\n"
        f"assert cli.main(['-i', {str(scenario)!r}, '--platform', 'cpu', '--quiet', "
        f"'--export', {out['json']!r}, '--snapshot', {out['png']!r}, "
        f"'--player', {out['html']!r}, '--record', {str(tmp_path / 'frames')!r}]) == 0\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN + ('yaml', 'PIL')!r}))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(Path(out["json"]).read_text())["scenario"] == "Crossing Lines"
    assert Path(out["png"]).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(list((tmp_path / "frames").glob("frame_*.png"))) == 5   # a sample a tick


def test_constants_equal_jax():
    names = {n for n in dir(JC) if n.isupper()}
    assert names == {n for n in dir(TC) if n.isupper()}
    for n in names:
        assert getattr(TC, n) == getattr(JC, n), n


@pytest.mark.parametrize("kind", list(JS.ScheduleKind), ids=lambda k: k.value)
def test_schedules_equal_jax(kind):
    assert [k.value for k in TS.ScheduleKind] == [k.value for k in JS.ScheduleKind]
    pairs = [(0, 0), (1, 0), (0, 1), (3, 3), (10, 10), (50, 10), (10, 50), (7, 12), (13, 4),
             (2, 9), (64, 1), (31, 32)]
    for internal, external in pairs:
        want = JS.schedule_booleans(kind, internal, external)
        assert TS.schedule_booleans(TS.ScheduleKind(kind.value), internal, external) == want, (
            internal, external)


def test_timesteps_equal_jax():
    for horizon in range(-2, 200):
        for multiple in (1, 2, 3, 4, 7):
            want = JTS.get_variable_timesteps(horizon, multiple)
            assert TTS.get_variable_timesteps(horizon, multiple) == want, (horizon, multiple)




def test_entry_points_default_to_the_card():
    """build_scenario, init_state (through it), state_from_numpy and
    Simulator build on CUDA unless asked for the CPU: without a card they
    raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default builds there")
    import numpy as np

    from magics_tpu_torch import convert
    from magics_tpu_torch.config.formation import Formation, FormationGroup
    from magics_tpu_torch.config.loader import Scenario
    from magics_tpu_torch.config.schema import Config
    from magics_tpu_torch.env import builtin
    from magics_tpu_torch.sim import builder as TB
    from magics_tpu_torch.sim.simulator import Simulator

    specs = TB.circle_formation(4, circle_radius=10.0, target_speed=5.0)
    with pytest.raises(RuntimeError, match="cuda"):
        TB.build_scenario(specs, target_speed=5.0)
    params, state, _ = TB.build_scenario(specs, target_speed=5.0, device="cpu")
    assert state.device.type == "cpu" and params.use_pallas is None
    assert not params.uses_kernels(state.device)
    assert params.uses_kernels(torch.device("cuda"))
    arrays = convert.state_to_numpy(state)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.state_from_numpy(arrays)
    assert convert.state_from_numpy(arrays, device="cpu").device.type == "cpu"
    assert np.array_equal(convert.state_to_numpy(state)["pos"], arrays["pos"])

    formation = Formation.parse({
        "robots": 3,
        "initial-position": {"shape": {"circle": {"radius": 20.0}}},
        "waypoints": [{"shape": {"circle": {"radius": 20.0}}, "projection-strategy": "cross"}],
    })
    scenario = Scenario(name="circle", config=Config.from_toml("[simulation]\nhz = 10.0\n"),
                        environment=builtin.circle(), formations=FormationGroup([formation]))
    with pytest.raises(RuntimeError, match="cuda"):
        Simulator(scenario)
    sim = Simulator(scenario, device="cpu")
    assert sim.state.device.type == "cpu" and sim.env_dist.device.type == "cpu"
    assert sim.generator.device.type == "cpu"
    assert sim.params.uses_kernels(torch.device("cuda"))


def test_harnesses_default_to_the_card(tmp_path):
    """The experiment sweep and the parity harness run on the card unless
    `--platform cpu`: without one they raise before they read or write a
    file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    from magics_tpu_torch.scripts import parity_rmse, run_experiment

    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="cuda"):
        run_experiment.main(["Missing", "--scenarios-dir", str(tmp_path), "--out", str(out)])
    with pytest.raises(RuntimeError, match="cuda"):
        parity_rmse.main(["--reference", str(tmp_path / "missing.npz")])
    assert not out.exists()


def test_checkpoint_load_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default builds there")
    from magics_tpu_torch.io import checkpoint
    from magics_tpu_torch.sim import builder as TB

    params, state, _ = TB.build_scenario(
        TB.circle_formation(4, circle_radius=10.0, target_speed=5.0), target_speed=5.0,
        device="cpu")
    checkpoint.save(tmp_path / "c.npz", state, params=params)
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.load(tmp_path / "c.npz")
    assert checkpoint.load(tmp_path / "c.npz", device="cpu")[0].device.type == "cpu"


# ---------------------------------------------------------------------------
# the framework-free copies, held to the JAX modules by behaviour
# ---------------------------------------------------------------------------

ENV_YAML = """
tiles:
  grid:
    - "┌┬"
    - "└┼"
  settings:
    tile-size: 40.0
    path-width: 0.3
    obstacle-height: 1.0
    sdf: {resolution: 40, expansion: 0.05, blur: 0.03}
obstacles:
  - shape: !circle {radius: 0.1}
    rotation: 0.0
    translation: {x: 0.4, y: 0.6}
    tile-coordinates: {row: 0, col: 1}
  - shape: !regular-polygon {sides: 5, radius: 0.08}
    rotation: 0.3
    translation: {x: 0.5, y: 0.5}
    tile-coordinates: {row: 1, col: 0}
  - shape: !triangle {angles: {A: 0.9, B: 1.1}, radius: 0.07}
    rotation: 1.0
    translation: {x: 0.6, y: 0.4}
    tile-coordinates: {row: 1, col: 1}
  - shape: !rectangle {width: 0.1, height: 0.05}
    rotation: 0.2
    translation: {x: 0.3, y: 0.3}
    tile-coordinates: {row: 0, col: 0}
"""

FORMATION_YAML = """
formations:
  - repeat: {every: {secs: 2, nanos: 0}, times: {finite: 3}}
    delay: {secs: 1, nanos: 500000000}
    robots: 5
    planning-strategy: rrt-star
    initial-position:
      shape: {line-segment: [{x: 0.1, y: 0.2}, {x: 0.1, y: 0.8}]}
      placement-strategy: {random: {attempts: 500}}
    waypoints:
      - shape: {line-segment: [{x: 0.9, y: 0.2}, {x: 0.9, y: 0.8}]}
        projection-strategy: cross
    waypoint-reached-when-intersects: {distance: 2.0, intersects-with: current}
    finished-when-intersects: {intersects-with: {variable: 3}}
  - robots: 6
    initial-position:
      shape: {circle: {radius: 15.0, center: {x: 0.5, y: 0.5}}}
      placement-strategy: equal
    waypoints:
      - shape: {circle: {radius: 15.0, center: {x: 0.5, y: 0.5}}}
        projection-strategy: cross
"""

CONFIG_TOML = """
environment = "junction"
formation_group = "f"
[gbp]
sigma-factor-interrobot = 0.005
variables = 12
[gbp.iteration-schedule]
internal = 50
external = 10
schedule = "interleave-evenly"
[gbp.factors-enabled]
tracking = true
[gbp.tracking]
switch-padding = 2.5
[robot]
target-speed = 15.0
radius = {min = 1.5, max = 2.5}
[robot.communication]
radius = 50.0
failure-rate = 0.7
[simulation]
hz = 10.0
prng-seed = 805
max-time = 120.0
[rrt]
max-iterations = 5000
[rrt.smoothing]
enabled = false
[visualisation.draw]
robots = true
"""


def _plain(obj):
    """A dataclass tree of either package as nested builtins (class names
    for classes, values for enums), so the two packages' trees compare."""
    import dataclasses
    import enum

    import numpy as np

    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


@pytest.mark.parametrize("name", ["yaml", "intersection", "intermediate", "complex",
                                  "circle", "maze", "test"])
def test_environment_copies_equal_jax(name):
    """env/model, env/builtin, env/sdf and env/obstacles: the same parsed
    environment, SDF, raster, distance transform and exported obstacles."""
    import numpy as np

    from magics_tpu.env import builtin as JBI
    from magics_tpu.env import model as JM
    from magics_tpu.env import obstacles as JO
    from magics_tpu.env import sdf as JSDF
    from magics_tpu_torch.env import builtin as TBI
    from magics_tpu_torch.env import model as TM
    from magics_tpu_torch.env import obstacles as TO
    from magics_tpu_torch.env import sdf as TSDF

    if name == "yaml":
        jenv, tenv = JM.Environment.from_yaml(ENV_YAML), TM.Environment.from_yaml(ENV_YAML)
        assert len(tenv.obstacles) == 4
    else:
        jenv, tenv = JBI.BUILTINS[name](), TBI.BUILTINS[name]()
    # a lower resolution keeps the rasters small; both packages alike
    jenv.sdf.resolution = tenv.sdf.resolution = 16 if name == "maze" else 40
    assert _plain(tenv) == _plain(jenv)
    assert tenv.world_size == jenv.world_size
    np.testing.assert_array_equal(TSDF.env_to_sdf(tenv), JSDF.env_to_sdf(jenv))
    timg, jimg = TSDF.env_to_image(tenv, expansion=0.0), JSDF.env_to_image(jenv, expansion=0.0)
    np.testing.assert_array_equal(timg, jimg)
    assert (jimg == 0).any() or name == "circle"
    mpp = jenv.world_size[0] / jimg.shape[1]
    np.testing.assert_array_equal(TSDF.distance_transform(timg == 0, mpp),
                                  JSDF.distance_transform(jimg == 0, mpp))
    assert TO.export_obstacles(tenv) == JO.export_obstacles(jenv)


def test_config_and_formation_copies_equal_jax():
    """config/schema, config/formation, config/dump: the same parsed trees,
    `to_plain` dicts, TOML texts and dump texts; the formations place robots
    alike from one generator."""
    import numpy as np

    from magics_tpu.config import dump as JD
    from magics_tpu.config import formation as JF
    from magics_tpu.config import schema as JSC
    from magics_tpu_torch.config import dump as TD
    from magics_tpu_torch.config import formation as TF
    from magics_tpu_torch.config import schema as TSC

    jcfg, tcfg = JSC.Config.from_toml(CONFIG_TOML), TSC.Config.from_toml(CONFIG_TOML)
    assert _plain(tcfg) == _plain(jcfg)
    assert TD.to_plain(tcfg) == JD.to_plain(jcfg)
    assert TSC.config_to_toml(tcfg) == JSC.config_to_toml(jcfg)
    assert TD.to_toml(TD.to_plain(tcfg)) == JD.to_toml(JD.to_plain(jcfg))
    assert _plain(TSC.Config.from_toml(TSC.config_to_toml(tcfg)).robot) == _plain(tcfg.robot)
    for fn in ("default_config_toml", "default_formation_yaml", "default_environment_yaml"):
        assert getattr(TD, fn)() == getattr(JD, fn)(), fn

    jgroup = JF.FormationGroup.from_yaml(FORMATION_YAML)
    tgroup = TF.FormationGroup.from_yaml(FORMATION_YAML)
    assert _plain(tgroup) == _plain(jgroup) and len(tgroup.formations) == 2
    for jf, tf in zip(jgroup.formations, tgroup.formations):
        radii = np.full(tf.robots, 2.0)
        jpos = jf.as_positions((100.0, 80.0), radii, np.random.default_rng(5))
        tpos = tf.as_positions((100.0, 80.0), radii, np.random.default_rng(5))
        np.testing.assert_array_equal(tpos[0], jpos[0])
        for a, b in zip(tpos[1], jpos[1]):
            np.testing.assert_array_equal(a, b)


def test_scenario_loader_copy_equals_jax(tmp_path):
    """config/loader: a scenario directory of this file's texts loads alike
    in both packages."""
    from magics_tpu.config import loader as JL
    from magics_tpu_torch.config import loader as TL

    root = tmp_path / "scenarios"
    for name in ("b", "a"):
        d = root / name
        d.mkdir(parents=True)
        (d / "config.toml").write_text(CONFIG_TOML)
        (d / "environment.yaml").write_text(ENV_YAML)
        (d / "formation.yaml").write_text(FORMATION_YAML)
    (root / "not-a-scenario").mkdir()
    assert TL.list_scenarios(root) == JL.list_scenarios(root) == ["a", "b"]
    assert TL.list_scenarios(tmp_path / "absent") == []
    j, t = JL.load_scenario(root / "a"), TL.load_scenario(root / "a")
    assert t.name == j.name == "a" and t.path == j.path
    for part in ("config", "environment", "formations"):
        assert _plain(getattr(t, part)) == _plain(getattr(j, part)), part


def test_metrics_and_analysis_copies_equal_jax():
    """io/metrics and analysis on the same synthetic export."""
    import numpy as np

    from magics_tpu import analysis as JA
    from magics_tpu.io import metrics as JMET
    from magics_tpu_torch import analysis as TA
    from magics_tpu_torch.io import metrics as TMET

    rng = np.random.default_rng(2)
    t = np.arange(60) * 0.1
    vel = np.stack([15 + np.sin(t) + 0.1 * rng.normal(size=60), np.cos(2 * t)], axis=1)
    pos = np.cumsum(vel * 0.1, axis=0)
    assert TMET.log_dimensionless_jerk(vel, t) == JMET.log_dimensionless_jerk(vel, t)
    assert TMET.distance_travelled(pos) == JMET.distance_travelled(pos)
    export = {"makespan": 6.0, "robots": {
        str(i): {
            "positions": (pos + i).tolist(),
            "velocities": [{"velocity": [v[0], 0.0, v[1]], "timestamp": float(ti)}
                           for v, ti in zip(vel * (1 + 0.1 * i), t)],
            "mission": {"waypoints": [[0.0, 0.0], [float(pos[-1, 0]), 0.0]], "duration": 5.9},
        } for i in range(3)}}
    want = JA.analyse(export)
    assert TA.analyse(export) == want and want["ldj"]["n"] == 3

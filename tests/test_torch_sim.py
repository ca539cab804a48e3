"""The port's Simulator (magics_tpu_torch/sim/simulator.py) against the JAX
package's on the CPU, on one in-memory scenario: a TOML config, two
formations parsed from dicts (random placement on line segments, radii drawn
from a range, the second on a repeat timer) and a builtin environment. No
scenario file is read and no YAML is parsed.

8 robots, V=9, 40 float64 ticks in chunks of 10: the JAX Simulator jits
`run_ticks` per chunk on its XLA path, the port runs it eagerly on the CPU.
Random placement keeps exact distance ties out (ROADMAP F2); with
`n_slots = R - 1` every in-range pair is connected, so the neighbour sets
are compared, not the slot order.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu import analysis as JA
from magics_tpu.config.formation import Formation as JFormation
from magics_tpu.config.formation import FormationGroup as JGroup
from magics_tpu.config.loader import Scenario as JScenario
from magics_tpu.config.schema import Config as JConfig
from magics_tpu.env import builtin as JEnv
from magics_tpu.io import checkpoint as JCK
from magics_tpu.sim.simulator import Simulator as JSimulator
from magics_tpu_torch import analysis as TA
from magics_tpu_torch.config.formation import Formation as TFormation
from magics_tpu_torch.config.formation import FormationGroup as TGroup
from magics_tpu_torch.config.loader import Scenario as TScenario
from magics_tpu_torch.config.schema import Config as TConfig
from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.env import builtin as TEnv
from magics_tpu_torch.io import checkpoint as TCK
from magics_tpu_torch.sim import simulator as TS

TICKS = 40
CHUNK = 10

TOML = """
[simulation]
hz = 10.0
prng-seed = 31
max-time = 30.0
despawn-robot-when-final-waypoint-reached = false

[gbp]
sigma-factor-interrobot = 0.005
lookahead-multiple = 3
[gbp.iteration-schedule]
internal = 6
external = 3
schedule = "interleave-evenly"
[gbp.factors-enabled]
tracking = false

[robot]
target-speed = 15.0
planning-horizon = 1.0
[robot.radius]
min = 1.5
max = 2.5
[robot.communication]
radius = 30.0
failure-rate = 0.0
"""

FORMATIONS = [
    {
        "robots": 4,
        "initial-position": {
            "shape": {"line-segment": [{"x": 0.3, "y": 0.1}, {"x": 0.7, "y": 0.1}]},
            "placement-strategy": "random",
        },
        "waypoints": [{
            "shape": {"line-segment": [{"x": 0.3, "y": 0.9}, {"x": 0.7, "y": 0.9}]},
            "projection-strategy": "identity",
        }],
        "finished-when-intersects": {"distance": 3.0, "intersects-with": "current"},
    },
    {
        "robots": 2,
        "delay": {"secs": 0, "nanos": 500_000_000},
        "repeat": {"every": {"secs": 1, "nanos": 0}, "times": {"finite": 2}},
        "initial-position": {
            "shape": {"line-segment": [{"x": 0.1, "y": 0.3}, {"x": 0.1, "y": 0.7}]},
            "placement-strategy": "random",
        },
        "waypoints": [{
            "shape": {"line-segment": [{"x": 0.9, "y": 0.3}, {"x": 0.9, "y": 0.7}]},
            "projection-strategy": "cross",
        }],
    },
]


def scenario(config, formation, group, scenario_cls, env_module):
    return scenario_cls(
        name="Crossing Lines",
        config=config.from_toml(TOML),
        environment=env_module.intersection(),
        formations=group([formation.parse(f) for f in FORMATIONS]),
    )


def jax_scenario():
    return scenario(JConfig, JFormation, JGroup, JScenario, JEnv)


def port_scenario():
    return scenario(TConfig, TFormation, TGroup, TScenario, TEnv)


@pytest.fixture(scope="module")
def runs():
    """Both Simulators after TICKS float64 ticks in chunks of CHUNK, with
    their run results and exports."""
    jsim = JSimulator(jax_scenario(), dtype=jnp.float64)
    tsim = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu")
    jres = jsim.run(max_ticks=TICKS, chunk_ticks=CHUNK)
    tres = tsim.run(max_ticks=TICKS, chunk_ticks=CHUNK)
    return dict(jsim=jsim, tsim=tsim, jres=jres, tres=tres,
                jexp=jsim.export(), texp=tsim.export())


def test_specs_equal_for_one_seed():
    """Spawn pre-planning draws the same radii and placements in the same
    order: every RobotSpec field equal, for the scenario's seed and another."""
    for seed in (None, 805):
        jsim = JSimulator(jax_scenario(), dtype=jnp.float64, seed=seed)
        tsim = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu", seed=seed)
        assert len(tsim.specs) == len(jsim.specs) == 8
        assert tsim.n_slots == jsim.n_slots == 7
        assert tsim._spawn_groups == jsim._spawn_groups
        for a, b in zip(jsim.specs, tsim.specs):
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
                else:
                    assert x == y, f.name
        assert sorted({s.spawn_tick for s in tsim.specs}) == [0, 5, 15]
        np.testing.assert_array_equal(tsim.env_dist_np, jsim.env_dist_np)
        np.testing.assert_array_equal(tsim.sdf.numpy(), np.asarray(jsim.sdf))
        assert tsim.params.n_vars == jsim.params.n_vars <= 11
        assert tsim.env_dist.device == tsim.state.device


def test_run_results_equal(runs):
    assert runs["tres"] == runs["jres"]
    assert runs["tres"]["ticks"] == TICKS


def test_float64_positions_and_neighbour_sets_match(runs):
    jstate, tstate = runs["jsim"].state, state_to_numpy(runs["tsim"].state)
    jpos = np.asarray(jstate.pos)
    assert np.abs(tstate["pos"] - jpos).max() <= 1e-6
    assert np.abs(jpos - np.asarray(runs["jsim"].specs[0].start[:2])).max() > 5.0

    def sets(idx, mask):
        return [set(row[m].tolist()) for row, m in zip(idx, mask)]

    jsets = sets(np.asarray(jstate.nbr_idx), np.asarray(jstate.nbr_mask))
    assert sets(tstate["nbr_idx"], tstate["nbr_mask"]) == jsets
    assert sum(map(len, jsets)) > 0
    for name in ("active", "completed", "msg_counts", "rr_count", "tick", "log_head"):
        np.testing.assert_array_equal(tstate[name], np.asarray(getattr(jstate, name)),
                                      err_msg=name)


def _compare(a, b, path="export"):
    """Same keys and types, equal integers and strings, floats within
    1e-6 (absolute, or relative past 1)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, set(a) ^ set(b))
        for k in a:
            _compare(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{path}[{i}]")
    elif isinstance(a, bool) or a is None or isinstance(a, str):
        assert a == b, path
    elif isinstance(a, int):
        assert isinstance(b, int) and a == b, (path, a, b)
    else:
        assert abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(a))), (path, a, b)


def test_exports_equal(runs):
    jexp, texp = runs["jexp"], runs["texp"]
    assert "viz" in texp and "diagnostics" in texp and len(texp["robots"]) == 8
    assert texp["config"] == jexp["config"]
    _compare(jexp, texp)


def test_analysis_equal(runs):
    ja, ta = JA.analyse(runs["jexp"]), TA.analyse(runs["texp"])
    assert ta["ldj"]["n"] > 0 and ta["distance_travelled"]["mean"] > 10.0
    _compare(ja, ta, "analysis")


def test_checkpoints_cross_the_packages(runs, tmp_path):
    """A Simulator checkpoint of either package resumes bit-exactly in the
    other's Simulator, and the resumed runs continue alike."""
    jsim, tsim = runs["jsim"], runs["tsim"]
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jsim.save_checkpoint(jpath)
    tsim.save_checkpoint(tpath)

    fresh_t = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu")
    fresh_t.resume(jpath)
    got = state_to_numpy(fresh_t.state)
    for name, a in got.items():
        b = np.asarray(getattr(jsim.state, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)

    state, meta = JCK.load(tpath, params=jsim.params)
    assert meta == {"version": 1, "scenario": "Crossing Lines", "seed": 31,
                    "use_grid": False, "collision_partners": 8}
    want = state_to_numpy(tsim.state)
    for name, a in want.items():
        np.testing.assert_array_equal(np.asarray(getattr(state, name)), a, err_msg=name)
    with np.load(tpath) as data:
        assert TCK.GENERATOR_KEY in data.files


def test_resume_continues_as_the_uninterrupted_run(tmp_path):
    """Save at tick 20, resume in a fresh Simulator, run to 30: every field
    bit-equal to 30 uninterrupted ticks; reset() gives the fresh initial
    state back."""
    whole = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu")
    initial = state_to_numpy(whole.state)
    whole.run(max_ticks=20, chunk_ticks=CHUNK)
    path = tmp_path / "mid.npz"
    whole.save_checkpoint(path)
    whole.run(max_ticks=30, chunk_ticks=CHUNK)
    resumed = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu")
    resumed.resume(path)
    resumed.run(max_ticks=30, chunk_ticks=CHUNK)
    a, b = state_to_numpy(whole.state), state_to_numpy(resumed.state)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    whole.reset()
    again = state_to_numpy(whole.state)
    for name in initial:
        np.testing.assert_array_equal(again[name], initial[name], err_msg=name)
    assert whole.diagnostics.time == [] and all(not rl.positions for rl in whole.logs)


def test_max_ticks_zero_runs_no_tick():
    """ROADMAP F4: `max_ticks=0` runs 0 ticks (the JAX package's
    `max_ticks or ...` ran the whole scenario)."""
    sim = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu")
    before = state_to_numpy(sim.state)
    result = sim.run(max_ticks=0)
    assert result["ticks"] == 0 and int(sim.state.tick) == 0
    assert sim.diagnostics.time == []
    after = state_to_numpy(sim.state)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name], err_msg=name)
    assert sim.export()["makespan"] == 0.0


def test_live_set_and_save_settings(tmp_path):
    sim = TS.Simulator(port_scenario(), dtype=torch.float64, device="cpu")
    assert TS.apply_live_set(sim, "comms-radius", "12.5") == "comms_radius = 12.5"
    assert TS.apply_live_set(sim, "tracking_enabled", "True") == "tracking_enabled = True"
    assert sim.params.comms_radius == 12.5 and sim.params.tracking_enabled
    with pytest.raises(KeyError, match="not live-editable"):
        TS.apply_live_set(sim, "n_vars", 3)
    sim.run(max_ticks=3, chunk_ticks=CHUNK)
    path = sim.save_settings(tmp_path / "config.toml")
    assert TConfig.from_file(path).robot.target_speed == 15.0
    with pytest.raises(ValueError, match="pass a path"):
        sim.save_settings()


def test_comms_failure_draws_follow_the_seed():
    """The comms-failure generator lives on the state's device, seeded from
    the scenario seed: one seed gives bit-equal runs, another differs."""
    def run(seed):
        sc = port_scenario()
        sc.config.robot.communication.failure_rate = 0.7
        sim = TS.Simulator(sc, dtype=torch.float64, device="cpu", seed=seed)
        assert sim.generator.device == sim.state.device
        sim.run(max_ticks=20, chunk_ticks=CHUNK)
        return state_to_numpy(sim.state)

    a, b, c = run(3), run(3), run(4)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert not np.array_equal(a["pos"], c["pos"])

"""The port's shell modules against the JAX package's, on the CPU: the
kernel-path choice of `GbpParams` (F10), the diagnostics recorder, the
in-flight mission flow, checkpoints across the two packages, the global
planner's backend, and the committed JAX trajectory of the 4-robot crossing
that the card test holds the kernels against.

Float64 where maths is compared; the JAX package runs under `jax.jit` on
its XLA path, the port on its plain passes (`device="cpu"`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.graph import tick as JT
from magics_tpu.io import checkpoint as JCK
from magics_tpu.io.diagnostics import DiagnosticsRecorder as JRecorder
from magics_tpu.planner.mission import MissionManager as JMission
from magics_tpu.sim import builder as JB
from magics_tpu_torch.convert import params_from_jax, state_to_numpy
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.graph.state import GbpParams
from magics_tpu_torch.io import checkpoint as TCK
from magics_tpu_torch.io.diagnostics import DiagnosticsRecorder as TRecorder
from magics_tpu_torch.kernels import gbp_slot as G
from magics_tpu_torch.planner.mission import MissionManager as TMission
from magics_tpu_torch.sim import builder as TB

REPO = Path(__file__).resolve().parents[1]
CUDA = torch.device("cuda")


# ------------------------------------------------------------------ F10 ---

def _params(**kw):
    return GbpParams(n_vars=kw.pop("n_vars", 21), n_slots=4, max_waypoints=2, **kw)


def test_default_kernel_path_is_float32_and_a_chain_the_kernels_take():
    """use_pallas=None: the kernels on a CUDA state only for float32 and a
    V with 3 <= V whose staged tiles fit; the plain passes otherwise, and
    always on the CPU. No card or build is needed to ask."""
    assert _params().uses_kernels(CUDA)
    assert not _params().uses_kernels(torch.device("cpu"))
    assert not _params(dtype=torch.float64).uses_kernels(CUDA)
    assert not _params(n_vars=2).uses_kernels(CUDA)
    last = max(v for v in range(3, 2000)
               if G.slot_tile("internal", v) and G.slot_tile("variable", v))
    assert _params(n_vars=last).uses_kernels(CUDA)
    assert not _params(n_vars=last + 1).uses_kernels(CUDA)
    assert G.kernels_take(last + 1, torch.float32) is not None


def test_slot_tiles_follow_the_kernels_shared_memory():
    """The tile sizes the kernels pick (gbp_slot.cu: 8-robot tiles at the
    bench's V=21; smaller as V grows; none past shared memory), reckoned
    from the staged rows: the internal slot stages 70V - 49 floats a robot,
    the variable slot 105V - 120, in 232,448 bytes."""
    for V in (3, 21, 100, 300, 600, 900):
        assert G._staged_rows("internal", V) == 70 * V - 49
        assert G._staged_rows("variable", V) == 105 * V - 120
    assert G.slot_tile("internal", 21) == G.slot_tile("variable", 21) == 8
    assert G.slot_tile("internal", 2) == 0
    for kind, per_robot in (("internal", lambda V: 70 * V - 49),
                            ("variable", lambda V: 105 * V - 120)):
        for V in range(3, 1000):
            tile = G.slot_tile(kind, V)
            fits = [t for t in (8, 4, 2, 1) if 4 * t * per_robot(V) <= 232448]
            assert tile == (fits[0] if fits else 0), (kind, V)
    assert G.slot_tile("variable", 554) == 1 and G.slot_tile("variable", 555) == 0


@pytest.mark.parametrize("case", ["v2", "v_past_tiles"])
def test_use_pallas_true_with_a_chain_the_kernels_do_not_take_raises_at_once(case):
    n_vars = 2 if case == "v2" else 555
    with pytest.raises(ValueError, match="use_pallas=True"):
        _params(n_vars=n_vars, use_pallas=True)
    assert not _params(n_vars=n_vars).uses_kernels(CUDA)


def test_use_pallas_true_float64_raises_where_the_device_is_the_card():
    """A float64 state takes the kernels' path on the CPU (its wrappers run
    their plain versions); on the card the kernels take float32 only, so
    building such a state, or stepping one, raises before any tick work."""
    p = _params(use_pallas=True, dtype=torch.float64)
    p.check_kernels(torch.device("cpu"))
    with pytest.raises(ValueError, match="float32"):
        p.check_kernels(CUDA)
    _params(use_pallas=True).check_kernels(CUDA)
    _params(dtype=torch.float64).check_kernels(CUDA)


# ---------------------------------------------------- shared scenarios ---

def _crossing(module, dtype, device=None, **extra):
    specs = module.circle_formation(6, circle_radius=20.0, target_speed=8.0)
    for i, s in enumerate(specs):
        s.start[:2] *= 1.0 + 0.03 * i
        s.waypoints[0, :2] *= 1.0 + 0.03 * i
    kw = dict(target_speed=8.0, planning_horizon=2.0, internal=4, external=2,
              n_slots=5, comms_radius=60.0, world=(100.0, 100.0), dtype=dtype, **extra)
    if device is not None:
        kw["device"] = device
    return module.build_scenario(specs, **kw)


def _jax_fields(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def crossing_runs():
    """8 float64 ticks of a 6-robot crossing in each package, sampled by
    each package's diagnostics recorder after every tick."""
    jp, js, jsdf = _crossing(JB, jnp.float64)
    tp, ts, tsdf = _crossing(TB, torch.float64, device="cpu")
    jrec, trec = JRecorder(n_vars=jp.n_vars), TRecorder(n_vars=tp.n_vars)
    step = jax.jit(JT.step, static_argnums=2)
    for k in range(8):
        js = step(js, jsdf, jp)
        ts = TT.step(ts, tsdf, tp)
        jrec.sample(js, jp, (k + 1) / jp.hz)
        trec.sample(ts, tp, (k + 1) / tp.hz)
    return dict(jax=(jp, js, jrec), port=(tp, ts, trec))


def test_diagnostics_equal_jax(crossing_runs):
    _, _, jrec = crossing_runs["jax"]
    _, _, trec = crossing_runs["port"]
    assert trec.as_dict() == jrec.as_dict()
    assert trec.external_factors[-1] > 0 and trec.msgs_sent_internal[-1] > 0


# ------------------------------------------------------- checkpoints ---

def _assert_fields_equal(want: dict, got: dict, skip=()):
    names = set(want) - set(skip)
    assert names == set(got) - set(skip)
    for name in sorted(names):
        a, b = want[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_jax_checkpoint_loads_bit_exactly_in_the_port(crossing_runs, tmp_path):
    jp, js, _ = crossing_runs["jax"]
    path = tmp_path / "jax.npz"
    JCK.save(path, js, params=jp, meta={"scenario": "crossing", "seed": 7})
    state, meta = TCK.load(path, params=params_from_jax(jp), device="cpu")
    assert meta["scenario"] == "crossing" and meta["seed"] == 7
    _assert_fields_equal({k: v for k, v in _jax_fields(js).items() if k != "rng"},
                         state_to_numpy(state))


def test_port_checkpoint_loads_bit_exactly_in_jax(crossing_runs, tmp_path):
    tp, ts, _ = crossing_runs["port"]
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    path = tmp_path / "port.npz"
    TCK.save(path, ts, params=tp, generator=gen, meta={"scenario": "crossing", "seed": 7})
    jstate, meta = JCK.load(path)
    assert meta["seed"] == 7
    got = _jax_fields(jstate)
    np.testing.assert_array_equal(got.pop("rng"), np.asarray(jax.random.PRNGKey(7)))
    _assert_fields_equal(state_to_numpy(ts), got)
    # and back: the port restores the state and the generator's draws
    other = torch.Generator().manual_seed(0)
    again, _ = TCK.load(path, params=tp, device="cpu", generator=other)
    _assert_fields_equal(state_to_numpy(ts), state_to_numpy(again))
    assert torch.equal(torch.rand(8, generator=other), torch.rand(8, generator=gen))


def test_jax_prng_key_is_jax_s():
    for seed in (0, 7, 805, 2**31 - 1, 2**40 + 3):
        np.testing.assert_array_equal(TCK.jax_prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))


def test_checkpoint_refuses_another_collision_mode(crossing_runs, tmp_path):
    tp, ts, _ = crossing_runs["port"]
    path = tmp_path / "dense.npz"
    TCK.save(path, ts, params=tp)
    grid = dataclasses.replace(tp, grid_cell_size=20.0)
    with pytest.raises(ValueError, match="collision mode"):
        TCK.load(path, params=grid, device="cpu")


def test_checkpoint_defaults_fill_old_fields(crossing_runs, tmp_path):
    """A checkpoint without the fields added later (here the velocity log
    and the grid counters) loads with magics_tpu's defaults."""
    tp, ts, _ = crossing_runs["port"]
    path = tmp_path / "old.npz"
    TCK.save(path, ts, params=tp)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k not in ("vel_log", "grid_overflow")}
    np.savez(path, **arrays)
    state, _ = TCK.load(path, device="cpu")
    assert torch.isnan(state.vel_log).all() and int(state.grid_overflow) == 0
    assert torch.equal(state.pos, ts.pos)


# ------------------------------------------------ in-flight missions ---

class StubPlanner:
    """tests/test_mission_inflight.py's planner: straight 3-point segments,
    the first `fail_first` calls failing."""

    def __init__(self, fail_first: int = 0):
        self.calls = 0
        self.fail_first = fail_first

    def plan(self, start, goal, seed=0):
        self.calls += 1
        if self.calls <= self.fail_first:
            return None
        mid = (np.asarray(start) + np.asarray(goal)) / 2.0
        return np.stack([np.asarray(start, float), mid, np.asarray(goal, float)])


def _mission_build(module, manager, dtype, taskpoints, fail_first=1, **device):
    start = np.concatenate([taskpoints[0], [10.0, 0.0]])
    chain = [np.concatenate([p, [10.0, 0.0]]) for p in taskpoints]
    spec = module.RobotSpec(
        start=start, waypoints=np.stack(chain), radius=1.5, planning_strategy="rrt-star",
        inflight=True, taskpoints=np.asarray(taskpoints, float), fin_check_var=0,
        wp_check_var=-1,
    )
    params, state, sdf = module.build_scenario(
        [spec], target_speed=10.0, planning_horizon=3.0, hz=10.0, comms_radius=50.0,
        internal=10, external=2, n_slots=1, dtype=dtype, despawn_on_final_waypoint=False,
        waypoint_capacity=8, **device,
    )
    planner = StubPlanner(fail_first)
    mission = manager(params, lambda: planner, seed=3)
    mission.add_robot(0, np.asarray(taskpoints, float))
    return params, state, sdf, mission, planner


def test_inflight_mission_flow_equals_jax():
    """tests/test_mission_inflight.py's flow (a failed first plan retried,
    the plan applied mid-run, the robot driven along it), polled every 2
    ticks for 40 float64 ticks in both packages: the same mission states and
    planner calls after every poll, and every field of the final state
    within 1e-9 of its scale."""
    taskpoints = np.array([[-15.0, 0.0], [15.0, 0.0]])
    jp, js, jsdf, jm, jplan = _mission_build(JB, JMission, jnp.float64, taskpoints)
    tp, ts, tsdf, tm, tplan = _mission_build(TB, TMission, torch.float64, taskpoints,
                                             device="cpu")
    assert tm.deterministic
    step = jax.jit(JT.step, static_argnums=2)
    activated = None
    for t in range(40):
        js = step(js, jsdf, jp)
        ts = TT.step(ts, tsdf, tp)
        if (t + 1) % 2 == 0:
            js = jm.poll(js, t + 1)
            ts = tm.poll(ts, t + 1)
            assert [m.state for m in tm.missions.values()] == [
                m.state for m in jm.missions.values()], t
            assert tplan.calls == jplan.calls, t
            if activated is None and bool(ts.mission_active[0]):
                activated = t + 1
                want = _jax_fields(js)
                for name in ("belief_mean", "trk_timeout", "trk_path", "waypoints",
                             "dyn_v2f_eta", "plan_pending"):
                    np.testing.assert_allclose(state_to_numpy(ts)[name], want[name],
                                               rtol=0, atol=1e-9, err_msg=name)
    assert activated is not None and tplan.calls == 2
    want, got = _jax_fields(js), state_to_numpy(ts)
    moved = np.abs(got["pos"] - np.asarray(taskpoints[0])).max()
    assert moved > 5.0, moved
    for name in set(got):
        a, b = want[name], got[name]
        if name == "ir_int_seeded":
            # the JAX apply_plans' `where(mask, 0, seeded)` promotes the
            # flags to int; the port keeps the state's bool
            assert b.dtype == bool
            a = a != 0
        assert a.dtype == b.dtype, name
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            ok = ~np.isnan(a)
            np.testing.assert_array_equal(ok, ~np.isnan(b), err_msg=name)
            scale = max(np.abs(a[ok]).max(initial=0.0), 1.0)
            assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= 1e-9 * scale, name


def test_apply_plans_on_a_receiver_state_zeroes_the_peers_mirrors():
    """apply_plans under "receiver": the arrived robot's factor inboxes are
    mirrored on its peers' rows, which are zeroed; equal to JAX's."""
    from magics_tpu.planner.mission import apply_plans as japply
    from magics_tpu_torch.planner.mission import apply_plans as tapply

    jp, js, jsdf = _crossing(JB, jnp.float64, ext_exchange="receiver")
    tp, ts, tsdf = _crossing(TB, torch.float64, device="cpu", ext_exchange="receiver")
    step = jax.jit(JT.step, static_argnums=2)
    for _ in range(3):
        js, ts = step(js, jsdf, jp), TT.step(ts, tsdf, tp)
    rng = np.random.default_rng(0)
    R, W, V = 6, jp.max_waypoints, jp.n_vars
    mask = np.zeros(R, bool)
    mask[[1, 4]] = True
    args = (rng.normal(size=(R, W, 4)), rng.integers(1, W + 1, R).astype(np.int32),
            rng.normal(size=(R, W, 2)), rng.integers(1, W + 1, R).astype(np.int32))
    means = rng.normal(size=(R, V, 4))
    jout = japply(js, jnp.asarray(mask), *map(jnp.asarray, args), 10, jnp.asarray(means),
                  "receiver")
    tout = tapply(ts, torch.as_tensor(mask), *map(torch.as_tensor, args), 10,
                  torch.as_tensor(means), "receiver")
    want, got = _jax_fields(jout), state_to_numpy(tout)
    assert not got["ir_int_seeded"].all()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12, atol=1e-9, err_msg=name)


# ------------------------------------------------------------ planner ---

def test_global_planner_backend_is_recorded_and_plans_equal_jax():
    """The port builds its own copy of native/rrtstar.cpp (into its
    gitignored native/_build/), says which planner runs, and plans the same
    path as the JAX package's for one seed, native and numpy alike."""
    from magics_tpu.config.schema import RrtSection as JRrt
    from magics_tpu.env.sdf import distance_transform
    from magics_tpu.planner.global_planner import GlobalPlanner as JPlanner
    from magics_tpu_torch.config.schema import RrtSection as TRrt
    from magics_tpu_torch.native import _BUILD
    from magics_tpu_torch.planner.global_planner import GlobalPlanner as TPlanner

    obstacle = np.zeros((64, 64), dtype=bool)
    obstacle[:, 30:34] = True
    obstacle[28:36, 30:34] = False
    dist = distance_transform(obstacle, 100.0 / 64)
    kw = dict(max_iterations=20_000, step_size=5.0, collision_radius=2.0,
              neighbourhood_radius=8.0, smoothing_enabled=True, smoothing_max_iterations=100,
              smoothing_step_size=0.5)
    for fallback in (False, True):
        tp = TPlanner(dist, (100.0, 100.0), TRrt(**kw), force_fallback=fallback)
        jp = JPlanner(dist, (100.0, 100.0), JRrt(**kw), force_fallback=fallback)
        assert tp.backend == ("numpy" if fallback else "native")
        if not fallback:
            assert Path(_BUILD).parent == REPO / "magics_tpu_torch" / "native"
            assert any(_BUILD.glob("librrtstar-*.so"))
        a = tp.plan([-40.0, 0.0], [40.0, 0.0], seed=5)
        b = jp.plan([-40.0, 0.0], [40.0, 0.0], seed=5)
        assert a is not None
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------- the crossing reference ---

def _crossing_script():
    spec = importlib.util.spec_from_file_location(
        "torch_crossing_reference", REPO / "scripts" / "torch_crossing_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_committed_crossing_reference_is_the_jax_run():
    """scripts/torch_crossing_reference.py regenerates
    tests/data/torch_crossing_jax.npz: the same shape and dtype, the same
    positions (to 1e-4 m: XLA's CPU code may round otherwise on another
    CPU; on the machine that wrote it they are bit-equal)."""
    script = _crossing_script()
    committed = np.load(script.DEFAULT_OUT)["pos"]
    fresh = script.jax_positions()
    assert committed.shape == fresh.shape == (script.TICKS + 1, 4, 2)
    assert committed.dtype == fresh.dtype == np.float32
    np.testing.assert_allclose(fresh, committed, rtol=0, atol=1e-4)
    assert np.abs(committed[-1] - committed[0]).max() > 5.0


def test_port_plain_crossing_tracks_the_committed_reference():
    """The port's plain float32 passes on the CPU track the same reference
    within the 2.0 m the card test holds the kernels to."""
    script = _crossing_script()
    committed = np.load(script.DEFAULT_OUT)["pos"]
    params, state, sdf = script.crossing(TB, torch.float32, device="cpu")
    pos = [state.pos.numpy().copy()]
    for _ in range(script.TICKS):
        state = TT.step(state, sdf, params)
        pos.append(state.pos.numpy().copy())
    assert np.abs(np.stack(pos) - committed).max() < 2.0


# ------------------------------------------------------ the bench line ---

def test_headline_workload_and_line_are_bench_py_s():
    """magics_tpu_torch.bench.headline builds bench.py's workload (the same
    params as the JAX package's build_scenario with bench.py's arguments,
    but the exchange and kernel switches) and prints bench.py's line: its
    keys, count and unit string (bench.py:96-131), with no exchange in
    the unit."""
    from magics_tpu.core.schedule import ScheduleKind
    from magics_tpu_torch.bench import headline

    params, state, _ = headline.bench_scenario("sender", device="cpu")
    jp, _, _ = JB.build_scenario(
        JB.circle_formation(1024, circle_radius=800.0, target_speed=15.0), target_speed=15.0,
        planning_horizon=5.0, hz=10.0, comms_radius=50.0, internal=50, external=10,
        schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=32, world=(2000.0, 2000.0),
        sdf=np.ones((128, 128)), dtype=jnp.float32, despawn_on_final_waypoint=False,
        use_pallas=True, tracking_enabled=False, ext_exchange="sender")
    assert params == dataclasses.replace(params_from_jax(jp), use_pallas=None)
    assert state.n_robots == 1024

    line = headline.metric_line(params, 1024, 19.634, 0, 25.0)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "gbp_message_updates_per_s"
    assert line["unit"] == ("messages/s (R=1024, V=21, 50i+10e per tick, mean_degree=19.6, "
                            "nbr_overflow=0)")
    V = 21
    per_tick = 1024 * (50 * (2 * (2 * (V - 1) + (V - 2)) + 19.634 * (V - 1))
                       + 10 * 2 * 19.634 * (V - 1))
    assert line["value"] == round(per_tick * 25.0) and line["vs_baseline"] == 2.5
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            headline.main([])

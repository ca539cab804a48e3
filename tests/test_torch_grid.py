"""The port's swarm-scale path against magics_tpu's: the spatial grid
(magics_tpu_torch/graph/grid.py), grid connectivity and collisions, the
collision event records and `scan_schedule` (magics_tpu_torch/graph/tick.py).

The JAX functions run jitted on the CPU (eager float64 JAX is avoided, as
the JAX package's own tests avoid it); the port's on CPU tensors, where its
kernel wrappers take their plain versions. Scenarios are test_torch_tick.py's
16-robot crossing (circle perturbed by 1% per robot, ROADMAP fault F2) with
the grid on, and the set-ups of tests/test_grid.py and tests/test_schedule.py.

Tolerances: the grid functions equal entry for entry (they are integer maths
and gathers of the inputs); one float64 tick within 1e-8 of each vector's or
matrix's own scale with every discrete field equal (test_torch_tick.py's
rule); 20 float32 ticks within test_pallas_slot.py's 2.0 m; the port's grid
path bit-equal to its own dense path and `scan_schedule` bit-equal to the
unrolled schedule (the same operations in the same order); the float32
event records within 1e-6 of their own scale of JAX's (positions that
agree in float64 to ~1e-13, rounded to float32).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tick import EXACT, FIELD_GROUPS, _err, _specs

from magics_tpu.core.schedule import ScheduleKind
from magics_tpu.graph import grid as JG
from magics_tpu.graph import tick as JT
from magics_tpu.sim import builder as JB
from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.graph import grid as TG
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.sim import builder as TB

# --------------------------------------------------------------------------
# graph/grid.py, function by function
# --------------------------------------------------------------------------


def _positions(case: str, dtype):
    """(world, cell, search radius, capacity, pos, active) of a case, from a
    seeded numpy generator."""
    rng = np.random.default_rng({"uniform": 0, "overfull": 1, "outside": 2}[case])
    R = 40
    world = (100.0, 80.0)
    pos = rng.uniform(-45, 45, size=(R, 2)) * np.array([1.0, 0.8])
    active = rng.random(R) > 0.15
    capacity = 8
    if case == "overfull":
        # 14 robots inside one 10 m cell: 6 past the capacity
        pos[:14] = rng.uniform(1.0, 9.0, size=(14, 2))
        active[:14] = True
    if case == "outside":
        # robots past the world's edge, beyond the margin ring, and far away
        pos[:8] = np.array([[60.0, 0.0], [-58.0, 3.0], [0.0, 45.0], [0.0, -52.0],
                            [75.0, 70.0], [-1e4, 2.0], [3.0, 1e5], [-61.0, -47.0]])
        active[:8] = True
    return world, 10.0, 17.0, capacity, pos.astype(dtype), active


CASES = ["uniform", "overfull", "outside"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_grid_functions_match_jax(case, dtype):
    world, cell, radius, capacity, pos, active = _positions(case, dtype)
    rad = np.random.default_rng(5).uniform(0.5, 2.0, size=len(pos)).astype(dtype)
    jspec = JG.make_grid_spec(world, cell, radius, capacity)
    tspec = TG.make_grid_spec(world, cell, radius, capacity)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    assert tspec.n_candidates == jspec.n_candidates

    jp, ja, jr = jnp.asarray(pos), jnp.asarray(active), jnp.asarray(rad)
    tp, ta, tr = torch.as_tensor(pos), torch.as_tensor(active), torch.as_tensor(rad)

    def eq(want, got, what):
        want, got = np.asarray(want), got.numpy()
        assert want.shape == got.shape, what
        np.testing.assert_array_equal(want, got, err_msg=what)

    eq(jax.jit(JG.cell_ids, static_argnums=0)(jspec, jp, ja), TG.cell_ids(tspec, tp, ta), "cell")
    jcell, jbucket = jax.jit(JG.build_grid, static_argnums=0)(jspec, jp, ja)
    tcell, tbucket = TG.build_grid(tspec, tp, ta)
    eq(jcell, tcell, "build_grid cell")
    eq(jbucket, tbucket, "build_grid bucket")
    jtab = jax.jit(JG.build_grid_tables, static_argnums=0)(jspec, jp, ja, jr)
    ttab = TG.build_grid_tables(tspec, tp, ta, tr)
    for name, w, g in zip(("bucket", "bucket_pos", "bucket_rad"), jtab, ttab):
        eq(w, g, name)
    over = int(jax.jit(JG.grid_overflow, static_argnums=0)(jspec, jp, ja))
    assert int(TG.grid_overflow(tspec, tp, ta)) == over
    assert (over > 0) == (case == "overfull")

    jn = jax.jit(JG._stencil_cells, static_argnums=0)(jspec, jcell)
    tn = TG._stencil_cells(tspec, tcell)
    eq(jn[0], tn[0], "stencil ncid")
    eq(jn[1], tn[1], "stencil valid")
    jc = jax.jit(JG.candidate_neighbours, static_argnums=0)(jspec, jcell, jbucket, ja)
    tc = TG.candidate_neighbours(tspec, tcell, tbucket, ta)
    eq(jc[0], tc[0], "candidate ids")
    eq(jc[1], tc[1], "candidate mask")
    jd = jax.jit(JG.candidate_data, static_argnums=0)(jspec, jcell, *jtab, ja)
    td = TG.candidate_data(tspec, tcell, *ttab, ta)
    for name, w, g in zip(("cand_idx", "cand_pos", "cand_rad", "cand_mask"), jd, td):
        eq(w, g, name)


def test_overfull_cell_drops_the_robots_ranked_last():
    """The stable rank decides who is dropped: the bucket of the over-full
    cell holds its `capacity` lowest ids, in id order."""
    world, cell, radius, capacity, pos, active = _positions("overfull", np.float64)
    spec = TG.make_grid_spec(world, cell, radius, capacity)
    cid, bucket = TG.build_grid(spec, torch.as_tensor(pos), torch.as_tensor(active))
    crowded = int(cid[0])
    members = [i for i in range(len(pos)) if int(cid[i]) == crowded]
    assert len(members) > capacity
    assert bucket[crowded].tolist() == members[:capacity]


# --------------------------------------------------------------------------
# the tick on the grid path against the JAX package's
# --------------------------------------------------------------------------

GRID = dict(grid_cell_size=15.0, grid_capacity=16, collision_partners=15)


def _kw(dtype, exchange, **extra):
    return dict(
        target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
        internal=6, external=3, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=dtype,
        despawn_on_final_waypoint=False, tracking_enabled=False, ext_exchange=exchange,
        **{**GRID, **extra},
    )


def _jax_run(n: int, dtype, exchange: str, **extra) -> dict:
    params, state, sdf = JB.build_scenario(_specs(JB), **_kw(dtype, exchange, **extra))
    final = jax.jit(partial(JT.run_ticks, n=n), static_argnums=2)(state, sdf, params)
    return {f.name: np.asarray(getattr(final, f.name)) for f in dataclasses.fields(final)}


def _port_run(n: int, dtype, exchange: str, **extra):
    params, state, sdf = TB.build_scenario(
        _specs(TB), use_pallas=True, device="cpu", **_kw(dtype, exchange, **extra)
    )
    return state_to_numpy(TT.run_ticks(state, sdf, params, n)), state_to_numpy(state)


EXCHANGES = ("sender", "receiver_compact")
GROUPS = {**FIELD_GROUPS, "inter_robot": ("ir_v2f_ext_pos", "ext_inbox", "ir_f2v_ext")}
GRID_EXACT = EXACT[:-1] + ("rr_partner", "rr_partner_overflow", "grid_overflow", "rr_count")


@pytest.fixture(scope="module")
def one_tick_f64():
    return {e: (_jax_run(1, jnp.float64, e), _port_run(1, torch.float64, e)[0])
            for e in EXCHANGES}


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_grid_one_tick_float64_fields_match(one_tick_f64, exchange, group):
    jax_s, port_s = one_tick_f64[exchange]
    for name in GROUPS[group]:
        assert jax_s[name].shape == port_s[name].shape, name
        assert _err(name, jax_s, port_s) <= 1e-8, (name, _err(name, jax_s, port_s))


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_grid_one_tick_float64_discrete_and_remaining_fields(one_tick_f64, exchange):
    jax_s, port_s = one_tick_f64[exchange]
    assert set(port_s) == set(jax_s) - {"rng"}
    assert port_s["rr_overlap"].shape == (16, 0) and port_s["rr_partner"].shape == (16, 15)
    for name in GRID_EXACT:
        np.testing.assert_array_equal(jax_s[name], port_s[name], err_msg=name)
    for name in set(port_s) - set(GRID_EXACT).union(*GROUPS.values()):
        a, b = jax_s[name], port_s[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert _err(name, jax_s, port_s) <= 1e-8, (name, _err(name, jax_s, port_s))
    assert port_s["nbr_mask"].any() and np.abs(port_s["ext_inbox"]).max() > 0.0


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_grid_twenty_ticks_float32_trajectories_agree(exchange):
    jax_s = _jax_run(20, jnp.float32, exchange)
    port_s, start = _port_run(20, torch.float32, exchange)
    assert np.isfinite(port_s["pos"]).all()
    assert np.abs(port_s["pos"] - start["pos"]).max() > 1.0
    assert np.abs(port_s["ext_inbox"]).max() > 0.0
    assert np.abs(jax_s["pos"] - port_s["pos"]).max() < 2.0
    for name in ("grid_overflow", "rr_partner_overflow"):   # ample capacity and slots
        assert int(port_s[name]) == int(jax_s[name]) == 0, name


# --------------------------------------------------------------------------
# the port's grid path against its own dense path (tests/test_grid.py)
# --------------------------------------------------------------------------

def _build_dense_or_grid(grid: bool, exchange: str):
    """tests/test_grid.py's _build on the port: a 24-robot circle, float64,
    with ample bucket capacity and partner slots on the grid."""
    specs = TB.circle_formation(24, circle_radius=20.0, target_speed=8.0)
    over = dict(grid_cell_size=15.0, grid_capacity=64, collision_partners=23) if grid else {}
    return TB.build_scenario(
        specs, target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=30.0,
        internal=4, external=2, n_slots=8, dtype=torch.float64, device="cpu",
        ext_exchange=exchange, **over,
    )


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_grid_tick_bit_equal_to_dense(exchange):
    """25 ticks in lockstep: every shared field bit-equal, and the grid's
    partner sets equal the symmetrised dense overlap matrix."""
    pd, sd, sdf = _build_dense_or_grid(False, exchange)
    pg, sg, _ = _build_dense_or_grid(True, exchange)
    for _ in range(25):
        sd = TT.step(sd, sdf, pd)
        sg = TT.step(sg, sdf, pg)
    a, b = state_to_numpy(sd), state_to_numpy(sg)
    for name in set(a) - {"rr_overlap", "rr_partner"}:
        np.testing.assert_array_equal(a[name], b[name], err_msg=f"field {name} diverged")
    assert int(a["rr_collisions"]) > 0 and a["nbr_mask"].any()
    dense, partners = a["rr_overlap"], b["rr_partner"]
    assert dense.any()
    for i in range(dense.shape[0]):
        want = set(np.nonzero(dense[i])[0].tolist()) | set(np.nonzero(dense[:, i])[0].tolist())
        assert want == {int(j) for j in partners[i] if j >= 0}, i


# --------------------------------------------------------------------------
# overflow counters (tests/test_grid.py's set-ups) against JAX
# --------------------------------------------------------------------------

def _line_specs(module, xs):
    specs = []
    for x in xs:
        start = np.array([x, 0.0, 0.0, 0.0])
        goal = np.array([x, 20.0, 0.0, 0.0])
        specs.append(module.RobotSpec(start=start, waypoints=np.stack([start, goal]), radius=2.0))
    return specs


OVERFLOW = {
    # a colliding pair outside the comms radius: the stencil covers 2 radii
    "collision_outside_comms": (lambda m: _line_specs(m, (0.0, 3.0)), 1, dict(
        target_speed=1.0, planning_horizon=2.0, comms_radius=1.0, internal=1, external=0,
        n_slots=2, grid_cell_size=1.0, grid_capacity=8, collision_partners=4)),
    # 5 overlaps a robot, 2 partner slots: 3 dropped each
    "partner_overflow": (lambda m: _line_specs(m, [0.05 * i for i in range(6)]), 1, dict(
        target_speed=1.0, planning_horizon=2.0, comms_radius=1.0, internal=1, external=0,
        n_slots=8, grid_cell_size=1.0, grid_capacity=16, collision_partners=2)),
    # the circle-centre crush into one cell of capacity 2
    "grid_overflow_small": (lambda m: m.circle_formation(16, 6.0, 8.0), 3, dict(
        target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=30.0, internal=2,
        external=1, n_slots=8, grid_cell_size=15.0, grid_capacity=2, collision_partners=15)),
    "grid_overflow_ample": (lambda m: m.circle_formation(16, 6.0, 8.0), 3, dict(
        target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=30.0, internal=2,
        external=1, n_slots=8, grid_cell_size=15.0, grid_capacity=32, collision_partners=15)),
}


@pytest.mark.parametrize("case", sorted(OVERFLOW))
def test_overflow_counters_match_jax(case):
    make_specs, ticks, kw = OVERFLOW[case]
    jp, js, jsdf = JB.build_scenario(make_specs(JB), dtype=jnp.float64, **kw)
    jfinal = jax.jit(partial(JT.run_ticks, n=ticks), static_argnums=2)(js, jsdf, jp)
    tp, ts, tsdf = TB.build_scenario(make_specs(TB), dtype=torch.float64, device="cpu", **kw)
    tfinal = TT.run_ticks(ts, tsdf, tp, ticks)
    for name in ("grid_overflow", "rr_partner_overflow", "rr_collisions", "rr_count",
                 "rr_partner", "nbr_overflow"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jfinal, name)), getattr(tfinal, name).numpy(), err_msg=name)
    expected = {"collision_outside_comms": ("rr_collisions", 1),
                "partner_overflow": ("rr_partner_overflow", 18),
                "grid_overflow_ample": ("grid_overflow", 0)}.get(case)
    if expected:
        assert int(getattr(tfinal, expected[0])) == expected[1]
    if case == "grid_overflow_small":
        assert int(tfinal.grid_overflow) > 0


# --------------------------------------------------------------------------
# collision event records, dense and grid, against JAX
# --------------------------------------------------------------------------

EVENT_FIELDS = ("rr_events", "re_events")
EVENT_EXACT = ("rr_event_count", "re_event_count", "rr_collisions", "re_collisions",
               "rr_count", "re_count", "re_overlap")


def _crash_kw(dtype, grid: bool):
    """10 robots crossing a small circle with the inter-robot factors off, so
    they collide, 16 event slots (the ring wraps), over a seeded distance
    field with walls."""
    over = dict(grid_cell_size=6.0, grid_capacity=16, collision_partners=9) if grid else {}
    return dict(
        target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=10.0, internal=3,
        external=1, n_slots=4, world=(40.0, 40.0), dtype=dtype, interrobot_enabled=False,
        despawn_on_final_waypoint=False, collision_log_capacity=16, **over,
    )


def _env_dist():
    return np.random.default_rng(11).uniform(0.0, 6.0, size=(32, 32))


@pytest.mark.parametrize("path", ["dense", "grid"])
def test_collision_event_rings_match_jax(path):
    grid = path == "grid"
    env = _env_dist()
    jp, js, jsdf = JB.build_scenario(JB.circle_formation(10, 6.0, 8.0),
                                     **_crash_kw(jnp.float64, grid))
    run = jax.jit(partial(JT.run_ticks, n=8), static_argnums=2)
    jfinal = run(js, jsdf, jp, env_dist=jnp.asarray(env))
    tp, ts, tsdf = TB.build_scenario(TB.circle_formation(10, 6.0, 8.0), device="cpu",
                                     **_crash_kw(torch.float64, grid))
    tfinal = TT.run_ticks(ts, tsdf, tp, 8, torch.as_tensor(env))
    for name in EVENT_EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(jfinal, name)), getattr(tfinal, name).numpy(), err_msg=name)
    for name in EVENT_FIELDS:
        want, got = np.asarray(getattr(jfinal, name)), getattr(tfinal, name).numpy()
        assert want.dtype == got.dtype == np.float32, name
        scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1.0)
        assert (np.abs(want - got) / scale).max() <= 1e-6, name
    assert int(tfinal.rr_event_count) > 16 and int(tfinal.re_event_count) > 0
    assert (tfinal.rr_events[:, 6] > 0).any()    # the ring holds events of later ticks


def test_ring_keeps_the_last_events_of_a_tick():
    """More new events in one tick than ring slots: the last C of them stay,
    as a scatter applied in order leaves them, each at (count + rank) % C."""
    C, count = 4, 3
    ring = torch.zeros(C, 2)
    flat = torch.tensor([True, False, True, True, True, False, True, True])
    rows = torch.arange(16.0).reshape(8, 2)
    out = TT._ring_append(ring, torch.tensor(count, dtype=torch.int32), flat, rows)
    # ranks 0..5 land at (3 + rank) % 4: rank 2 -> 1, 3 -> 2, 4 -> 3, 5 -> 0
    want = torch.stack([rows[7], rows[3], rows[4], rows[6]])
    assert torch.equal(out, want)


# --------------------------------------------------------------------------
# scan_schedule (tests/test_schedule.py's set-up)
# --------------------------------------------------------------------------

def test_scan_schedule_equal_to_unrolled_and_to_jax():
    kw = dict(target_speed=8.0, planning_horizon=2.0, comms_radius=30.0, internal=6,
              external=3, n_slots=4)
    jp, js, jsdf = JB.build_scenario(JB.circle_formation(6, 20.0, 8.0), dtype=jnp.float64, **kw)
    jscan = dataclasses.replace(jp, scan_schedule=True)
    jfinal = jax.jit(partial(JT.run_ticks, n=8), static_argnums=2)(js, jsdf, jscan)
    tp, ts, tsdf = TB.build_scenario(TB.circle_formation(6, 20.0, 8.0), dtype=torch.float64,
                                     device="cpu", **kw)
    scan = state_to_numpy(TT.run_ticks(ts, tsdf, dataclasses.replace(tp, scan_schedule=True), 8))
    unrolled = state_to_numpy(TT.run_ticks(ts, tsdf, tp, 8))
    for name in scan:
        np.testing.assert_array_equal(scan[name], unrolled[name], err_msg=name)
    want = {f.name: np.asarray(getattr(jfinal, f.name)) for f in dataclasses.fields(jfinal)}
    for name in EXACT:
        np.testing.assert_array_equal(want[name], scan[name], err_msg=name)
    for name in FIELD_GROUPS["beliefs"] + ("pos", "ext_inbox"):
        assert _err(name, want, scan) <= 1e-8, (name, _err(name, want, scan))
    assert np.abs(scan["ext_inbox"]).max() > 0.0


# --------------------------------------------------------------------------
# the swarm-scale workload's coordinates (magics_tpu_torch/bench/scale.py)
# --------------------------------------------------------------------------

def test_belief_guard_rejects_a_rank_deficient_precision():
    """A rank-2 float32 precision met at the scale workload's 12.8 km
    coordinates: summed from rounded float32 products its residual cancels
    to exactly the identity, so that sum would pass the guard; the JAX
    package's XLA dot rejects it, and so does the port's float64 residual."""
    from magics_tpu.core import linalg as JL
    from magics_tpu_torch.core import linalg as TL

    lam = np.array([[2515.7356, 468.3684, 0, 0], [468.3684, 87.19872, 0, 0],
                    [0, 0, 117.04512, 21.79094], [0, 0, 21.79094, 4.0569396]],
                   np.float32)[None]
    _, jvalid = jax.jit(JL.belief_covariance)(jnp.asarray(lam))
    cov, valid = TL.belief_covariance(torch.as_tensor(lam))
    assert not bool(np.asarray(jvalid)[0]) and not bool(valid[0])
    f32_resid = (TL.mm(torch.as_tensor(lam), cov) - torch.eye(4)).abs().max()
    assert float(f32_resid) < 1e-4


def test_scale_coordinates_stay_finite_like_jax():
    """48 robots on the R=16384 workload's 12,777 m circle (grid, K=24, 10
    internal + 10 external CENTERED, tracking on), 3 float32 ticks of the
    port's hot path and of the JAX package: no robot's belief blows up in
    either, and the positions agree within test_pallas_slot.py's 2.0 m."""
    radius = 12777.0
    kw = dict(target_speed=15.0, planning_horizon=5.0, hz=10.0, comms_radius=50.0,
              internal=10, external=10, schedule=ScheduleKind.CENTERED, n_slots=24,
              world=(2.6 * radius, 2.6 * radius), sdf=np.ones((128, 128)),
              despawn_on_final_waypoint=False, ext_exchange="receiver_compact",
              grid_cell_size=50.0, grid_capacity=32, collision_partners=8)
    jp, js, jsdf = JB.build_scenario(JB.circle_formation(48, radius, 15.0), dtype=jnp.float32, **kw)
    jfinal = jax.jit(partial(JT.run_ticks, n=3), static_argnums=2)(js, jsdf, jp)
    tp, ts, tsdf = TB.build_scenario(TB.circle_formation(48, radius, 15.0), dtype=torch.float32,
                                     device="cpu", use_pallas=True, **kw)
    tfinal = state_to_numpy(TT.run_ticks(ts, tsdf, tp, 3))
    for mean in (np.asarray(jfinal.belief_mean), tfinal["belief_mean"]):
        assert np.isfinite(mean).all() and np.abs(mean[..., 2:]).max() < 100.0
    assert np.abs(np.asarray(jfinal.pos) - tfinal["pos"]).max() < 2.0
    assert int(tfinal["grid_overflow"]) == 0

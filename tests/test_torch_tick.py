"""The port's tick (magics_tpu_torch/graph/tick.py) as a whole against
magics_tpu's, on the bench workload scaled down: a 16-robot circle crossing
at 15 m/s, horizon 3 s, K=8 slots, 6 internal + 3 external GBP slots per
tick on interleave-evenly, "receiver_compact", tracking off, no comms
failure, an all-ones SDF.

The port runs with `use_pallas=True` (the hot-layout path; on the CPU its
slot wrappers take the plain versions), the JAX package with
`use_pallas=False` under `jax.jit(partial(run_ticks, n=...))`; the JAX
package's own test_pallas_slot holds that path equal to its Pallas one.

The circle is perturbed by 1% per robot: an exact circle makes exact
distance ties, and which neighbour a tie goes to then hangs on the last bit
of d^2, which XLA's fused CPU code and PyTorch round differently (ROADMAP
fault F2). The crossing is small enough that inter-robot factors engage.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.core.schedule import ScheduleKind
from magics_tpu.graph import tick as JT
from magics_tpu.sim import builder as JB
from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.kernels.gbp_slot import RESPONSE_OPERAND, scaled_error
from magics_tpu_torch.sim import builder as TB

R = 16


def _specs(module):
    specs = module.circle_formation(R, circle_radius=20.0, target_speed=15.0)
    for i, s in enumerate(specs):
        s.start[:2] *= 1.0 + 0.01 * i
        s.waypoints[0, :2] *= 1.0 + 0.01 * i
    return specs


def _kw(dtype, **extra):
    return dict(
        target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
        internal=6, external=3, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=dtype,
        despawn_on_final_waypoint=False, tracking_enabled=False,
        ext_exchange="receiver_compact", **extra,
    )


def _jax_run(n: int, dtype):
    params, state, sdf = JB.build_scenario(_specs(JB), **_kw(dtype))
    final = jax.jit(partial(JT.run_ticks, n=n), static_argnums=2)(state, sdf, params)
    return {f.name: np.asarray(getattr(final, f.name)) for f in dataclasses.fields(final)}


def _port_run(n: int, dtype, use_pallas=True):
    params, state, sdf = TB.build_scenario(
        _specs(TB), use_pallas=use_pallas, device="cpu", **_kw(dtype)
    )
    return state_to_numpy(TT.run_ticks(state, sdf, params, n)), state_to_numpy(state)


def _err(name: str, want: dict, got: dict) -> float:
    """Largest error of a robot-major field, each vector or matrix over its
    own scale, so the 1e30-pinned endpoint rows do not set the scale of the
    interior ones (gbp_slot.scaled_error)."""
    refs = {n: torch.as_tensor(np.array(want[n])) for n in (name, RESPONSE_OPERAND.get(name)) if n}
    return scaled_error(name, torch.as_tensor(np.array(got[name])), refs, hot_layout=False)


@pytest.fixture(scope="module")
def one_tick_f64():
    return _jax_run(1, jnp.float64), _port_run(1, torch.float64)[0]


FIELD_GROUPS = {
    "beliefs": ("belief_eta", "belief_lam", "belief_mean", "snap_eta", "snap_lam", "snap_mu"),
    "priors": ("prior_mean", "prior_sigma", "pos"),
    "dynamic": ("dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu", "dyn_f2v_eta", "dyn_f2v_lam"),
    "obstacle_tracking": (
        "obs_v2f_mu", "obs_f2v_eta", "obs_f2v_lam", "trk_v2f_mu", "trk_f2v_eta",
        "trk_f2v_lam", "trk_last_pos", "trk_last_val",
    ),
    "inter_robot": ("ir_v2f_ext_pos", "ext_inbox"),
}
EXACT = (
    "nbr_idx", "nbr_back", "nbr_mask", "nbr_has_back", "msg_counts", "ir_int_seeded",
    "iter_count_factor", "active", "antenna", "target_idx", "trk_record", "tick",
    "nbr_overflow", "rr_collisions", "rr_overlap",
)


@pytest.mark.parametrize("group", sorted(FIELD_GROUPS))
def test_one_tick_float64_fields_match(one_tick_f64, group):
    """1 tick in float64: every belief, message and inbox field within 1e-8
    of the scale of its own vector or matrix."""
    jax_s, port_s = one_tick_f64
    for name in FIELD_GROUPS[group]:
        assert jax_s[name].shape == port_s[name].shape, name
        assert _err(name, jax_s, port_s) <= 1e-8, (name, _err(name, jax_s, port_s))


def test_one_tick_float64_discrete_state_equal(one_tick_f64):
    """Connectivity, reciprocal slots, counters and flags are equal."""
    jax_s, port_s = one_tick_f64
    for name in EXACT:
        np.testing.assert_array_equal(jax_s[name], port_s[name], err_msg=name)
    assert port_s["nbr_mask"].any()


def test_one_tick_float64_remaining_fields_match(one_tick_f64):
    """Every other field (route, counters, collision and goal state) agrees
    too; `rng` has no counterpart in the port."""
    jax_s, port_s = one_tick_f64
    assert set(port_s) == set(jax_s) - {"rng"}
    for name in set(port_s) - set(EXACT).union(*FIELD_GROUPS.values()):
        a, b = jax_s[name], port_s[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert _err(name, jax_s, port_s) <= 1e-8, (name, _err(name, jax_s, port_s))


@pytest.fixture(scope="module")
def twenty_ticks_f32():
    return _jax_run(20, jnp.float32), _port_run(20, torch.float32)


def test_twenty_ticks_float32_trajectories_agree(twenty_ticks_f32):
    """20 ticks in float32 stay within the 2.0 m bound of
    test_pallas_slot.py:test_multi_tick_trajectories_agree."""
    jax_s, (port_s, start) = twenty_ticks_f32
    assert np.isfinite(port_s["pos"]).all()
    assert np.abs(port_s["pos"] - start["pos"]).max() > 1.0     # robots moved
    assert np.abs(port_s["ext_inbox"]).max() > 0.0                # factors engaged
    assert np.abs(jax_s["pos"] - port_s["pos"]).max() < 2.0


def test_port_plain_path_matches_hot_path_float32(twenty_ticks_f32):
    """The port's plain iterate_gbp and its hot-layout path are the same
    maths in another summation order: 20 float32 ticks agree to roundoff
    amplified by the crossing (measured ~4e-4 m; bound 0.05 m)."""
    _, (hot_s, _) = twenty_ticks_f32
    plain_s, _ = _port_run(20, torch.float32, use_pallas=False)
    assert np.abs(hot_s["pos"] - plain_s["pos"]).max() < 0.05
    np.testing.assert_array_equal(hot_s["nbr_idx"], plain_s["nbr_idx"])


def test_on_device_logs_match():
    """The position, velocity and belief-visualisation ring buffers: 7
    float64 ticks logged every 2nd tick into 3 / 2 slots, so both rings wrap
    and inactive robots log NaN (two robots spawn late)."""
    kw = dict(log_every=2, log_capacity=3, viz_log_capacity=2)
    jax_specs, port_specs = _specs(JB), _specs(TB)
    for specs in (jax_specs, port_specs):
        specs[2].spawn_tick = specs[5].spawn_tick = 5
    jp, js, jsdf = JB.build_scenario(jax_specs, **_kw(jnp.float64, **kw))
    jfinal = jax.jit(partial(JT.run_ticks, n=7), static_argnums=2)(js, jsdf, jp)
    tp, ts, tsdf = TB.build_scenario(
        port_specs, use_pallas=True, device="cpu", **_kw(torch.float64, **kw)
    )
    tfinal = state_to_numpy(TT.run_ticks(ts, tsdf, tp, 7))
    assert int(tfinal["log_head"]) == int(np.asarray(jfinal.log_head)) == 4
    for name in ("pos_log", "vel_log", "viz_mean", "viz_cov", "viz_trk"):
        a, b = np.asarray(getattr(jfinal, name)), tfinal[name]
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        assert np.isnan(a).any() and not np.isnan(a).all(), name
        ok = ~np.isnan(a)
        scale = max(np.abs(a[ok]).max(), 1.0)
        assert np.abs(a[ok] - b[ok]).max() <= 1e-6 * scale, name

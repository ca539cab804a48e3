"""The port's parity harness (magics_tpu_torch/scripts/parity_rmse.py)
against the JAX script's cases and the numpy oracle (tests/oracle.py), on
the CPU.

The port cannot run the oracle (it needs JAX), so it compares with the
oracle's committed trajectories, tests/data/torch_oracle_parity.npz
(scripts/torch_oracle_reference.py). Held here: the cases equal the
JAX script's; the port's initial state equals tests/compare_util.build_pair's;
the committed lanes trajectory is what the oracle runs now; the port tracks
the live oracle on the lanes case within 1e-6 m RMSE in float64 (4.6e-11
over 80 ticks, `parity_rmse --platform cpu`) and the committed one within
3e-3 m in float32 on the kernels' path (their plain versions on the CPU;
the JAX float32 tick is 2.1e-3 off over 80 ticks, ROADMAP F13).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.scripts import parity_rmse as TP
from scripts import parity_rmse as JP
from scripts import torch_oracle_reference as OR

LIVE_TICKS = 40
COMMITTED_TICKS = 20


@pytest.fixture(scope="module")
def reference():
    return TP.load_reference(OR.DEFAULT_OUT)


@pytest.mark.parametrize("name", list(TP.CASES))
def test_cases_equal_jax(name):
    got = getattr(TP, f"{name}_case")()
    want = getattr(JP, f"{name}_case")()
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] and got[3] == want[3]


@pytest.mark.parametrize("name", list(TP.CASES))
def test_initial_state_is_build_pairs(name):
    """The port's build_case gives build_pair's params and initial state,
    every field, in float64."""
    jparams, jstate, jsdf, _ = OR.pair(name)
    make, factors, _, _ = TP.CASES[name]
    params, state, sdf = TP.build_case(*make(), factors=factors, device="cpu")
    for field in ("n_vars", "n_slots", "max_waypoints", "schedule", "target_speed",
                  "planning_horizon_seconds", "comms_radius", "comms_failure_rate", "hz",
                  "world_width", "world_height", "sdf_shape", "variable_timesteps",
                  "sigma_factor_dynamics", "sigma_factor_interrobot", "sigma_factor_obstacle",
                  "sigma_factor_tracking", "dynamic_enabled", "interrobot_enabled",
                  "obstacle_enabled", "tracking_enabled", "despawn_on_final_waypoint",
                  "ext_exchange", "lookahead_multiple", "safety_distance_multiplier"):
        assert getattr(params, field) == getattr(jparams, field), field
    for field, got in state_to_numpy(state).items():
        want = np.asarray(getattr(jstate, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_array_equal(sdf.numpy(), np.asarray(jsdf))


@pytest.fixture(scope="module")
def live_lanes():
    """The oracle's lanes positions [T, R, 2] and flags [T, R] over
    LIVE_TICKS ticks, run now."""
    return OR.oracle_run("lanes", LIVE_TICKS)


def test_committed_reference_is_the_oracle_run(reference, live_lanes):
    """The npz's lanes trajectory is the oracle's, its first ticks rerun
    now (to 1e-8 m: the oracle's Schur step is XLA's CPU code, which may
    round otherwise on another CPU); every case has its ticks."""
    pos, done = live_lanes
    np.testing.assert_allclose(reference["lanes_pos"][:COMMITTED_TICKS], pos[:COMMITTED_TICKS],
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(reference["lanes_completed"][:COMMITTED_TICKS],
                                  done[:COMMITTED_TICKS])
    assert [len(reference[f"{c}_pos"]) for c in TP.CASES] == [80, 80, 80]
    assert reference["circle_pos"].shape[1:] == (8, 2)
    assert reference["junction_completed"].shape == (80, 6)


def test_port_float64_tracks_the_live_oracle(live_lanes):
    """Lanes, 40 ticks, float64 (the plain passes): RMSE within 1e-6 m of
    the oracle run now, the degree held at 5 (trajectory asserts it), the
    inter-robot factors' messages flowing."""
    params, state, sdf = TP.build_case(*TP.lanes_case(), factors=TP.NO_TRK, device="cpu")
    run = TP.trajectory(params, state, sdf, LIVE_TICKS)
    out = TP.score("lanes", run["pos"], run["completed"], *live_lanes, chaotic=False,
                   dtype=torch.float64)
    assert float(run["state"].ext_inbox.abs().mean()) > 1.0
    assert out["rmse_max_m"] < 1e-6, out["rmse_max_m"]
    assert out["ticks"] == LIVE_TICKS and len(out["divergence_curve_max_m"]) == LIVE_TICKS


def test_port_float32_kernel_path_tracks_the_oracle(reference):
    """Lanes, 40 ticks, float32 with use_pallas=True (the kernels' path;
    on the CPU their wrappers run their plain versions): within F13's 3e-3
    m of the committed oracle trajectory, completion equal."""
    out = TP.run_case("lanes", LIVE_TICKS, reference=reference, dtype=torch.float32,
                      device="cpu", use_pallas=True)
    assert out["rmse_max_m"] < 3e-3, out["rmse_max_m"]
    assert out["completed_dense"] == out["completed_oracle"]


def test_score_refuses_a_lanes_run_off_the_oracle(reference):
    """The bounds bite: a lanes trajectory 2 mm off every robot fails
    float64's 1e-3 and passes float32's 3e-3; 4 mm fails both; one more
    robot done than the oracle fails the well-conditioned case, two more
    the chaotic one."""
    ref_pos, ref_done = reference["lanes_pos"], reference["lanes_completed"]
    for off, dtype, ok in ((2e-3, torch.float64, False), (2e-3, torch.float32, True),
                           (4e-3, torch.float32, False)):
        pos = ref_pos + np.array([off, 0.0])
        if ok:
            TP.score("lanes", pos, ref_done, ref_pos, ref_done, chaotic=False, dtype=dtype)
        else:
            with pytest.raises(AssertionError, match="RMSE"):
                TP.score("lanes", pos, ref_done, ref_pos, ref_done, chaotic=False, dtype=dtype)
    for extra, chaotic, ok in ((1, False, False), (1, True, True), (2, True, False)):
        done = ref_done.copy()
        done[-1, :extra] = ~done[-1, :extra]
        if ok:
            TP.score("lanes", ref_pos, done, ref_pos, ref_done, chaotic=chaotic,
                     dtype=torch.float64)
        else:
            with pytest.raises(AssertionError, match="outcome"):
                TP.score("lanes", ref_pos, done, ref_pos, ref_done, chaotic=chaotic,
                         dtype=torch.float64)


def test_score_holds_chaotic_completion_ticks(reference):
    """A chaotic case's robots each finish within COMPLETION_WINDOW_TICKS
    (15) of the oracle's: junction's first robot 15 ticks late passes, 16
    fails; a circle robot that never finishes in 80 ticks fails, though the
    count of robots done is within the +-1 the JAX harness holds."""
    for name, robot, late, ticks, ok in (("junction", 0, 15, 80, True),
                                         ("junction", 0, 16, 80, False),
                                         ("circle", 7, None, 80, False)):
        ref_pos, ref_done = reference[f"{name}_pos"][:ticks], reference[f"{name}_completed"]
        done = ref_done[:ticks].copy()
        first = TP.completion_ticks(done)[robot]
        done[:, robot] = False
        if late is not None:
            done[first - 1 + late:, robot] = True
        if ok:
            TP.score(name, ref_pos, done, ref_pos, ref_done, chaotic=True, dtype=torch.float64)
        else:
            with pytest.raises(AssertionError, match="completion ticks"):
                TP.score(name, ref_pos, done, ref_pos, ref_done, chaotic=True,
                         dtype=torch.float64)


def test_main_on_the_cpu_against_the_reference(tmp_path, capsys):
    """`main --platform cpu`: lanes 80 float64 ticks against the committed
    trajectory within 1e-6 m, the circle 80 and junction the JAX harness's
    60, each to its bounds; the record written as the JAX script writes
    it; the reference's default the repo-relative path of the npz."""
    assert TP._parser().parse_args([]).reference == str(OR.DEFAULT_OUT.relative_to(OR.REPO))
    out = tmp_path / "parity.json"
    results = TP.main(["--platform", "cpu", "--reference", str(OR.DEFAULT_OUT),
                       "--json", str(out)])
    assert "well-conditioned RMSE" in capsys.readouterr().out
    assert json.loads(out.read_text()) == results
    lanes, circle, junction = results
    for rec in results:
        assert set(rec) == {"case", "regime", "robots", "ticks", "rmse_per_robot_m",
                            "rmse_max_m", "divergence_curve_max_m", "completed_dense",
                            "completed_oracle"}
    assert [r["ticks"] for r in results] == [80, 80, 60]
    assert [r["regime"] for r in results] == ["well-conditioned", "chaotic", "chaotic"]
    assert lanes["rmse_max_m"] < 1e-6, lanes["rmse_max_m"]

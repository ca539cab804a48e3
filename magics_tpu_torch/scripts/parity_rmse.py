"""Trajectory-parity RMSE harness: the port's dense tick against the
reference oracle (counterpart of scripts/parity_rmse.py).

BASELINE.md's parity row asks for <= 1e-3 RMSE on shipped-scenario workloads
at the same horizon and iteration budget. The oracle (tests/oracle.py) is a
per-robot numpy transcription of the reference algorithm; it needs JAX for
its 4x4 Schur step, so this harness, which imports no JAX, compares with its
committed trajectories: tests/data/torch_oracle_parity.npz, written by
scripts/torch_oracle_reference.py. Two regimes, as in the JAX harness:

* WELL-CONDITIONED (the `lanes` case): 6 robots, every pair connected
  (K = R-1), inter-robot factors active the whole run, no crossing
  conflict. The RMSE bound is asserted: 1e-3 in float64, where the dense
  tick tracks the oracle at roundoff, and 3e-3 in float32, where neither
  package meets 1e-3 (ROADMAP F13: the JAX float32 tick is ~2.1e-3 off the
  oracle on this case, on the CPU).
* CHAOTIC (`circle`, `junction`): antagonistic crossings amplify any epsilon
  to O(1) divergence; the divergence curve is recorded, completion is held
  within +-1 of the oracle's at the last tick, and each robot's completion
  tick within COMPLETION_WINDOW_TICKS of the oracle's. Junction runs the
  JAX harness's --ticks (60); the circle at least 80 (see CASES).

The cluttered case of the JAX harness is left out: it reads the reference's
own scenario files, which are not in the repo.

    python -m magics_tpu_torch.scripts.parity_rmse [--ticks N] [--json OUT]
        [--platform cuda|cpu] [--dtype float64|float32] [--reference NPZ]

--reference defaults to tests/data/torch_oracle_parity.npz under the
working directory: run it from the repo's root.

The run is on the card unless `--platform cpu`; without a card it raises.
Float64 (the default, as the JAX harness runs) takes the plain GBP passes
everywhere; float32 on the card runs the GBP slots through the kernels
(GbpParams.use_pallas=None), which take float32 only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from magics_tpu_torch.core.schedule import ScheduleKind, schedule_booleans
from magics_tpu_torch.core.timesteps import get_variable_timesteps
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.graph.state import GbpParams, init_state, require_device

# relative to the working directory, the repo's root, as the experiment
# harness's --scenarios-dir
DEFAULT_REFERENCE = "tests/data/torch_oracle_parity.npz"
DTYPES = {"float64": torch.float64, "float32": torch.float32}
# the well-conditioned case's RMSE bound per dtype (F13 for float32)
RMSE_BOUND = {torch.float64: 1e-3, torch.float32: 3e-3}
NO_TRK = ("dynamic", "obstacle", "interrobot")
ALL_FACTORS = ("dynamic", "obstacle", "tracking", "interrobot")

# the scenario every case runs in (scripts/parity_rmse.py:run_case through
# tests/compare_util.build_pair)
HORIZON_S = 3.0
COMMS_RADIUS = 250.0     # saturating: every pair stays in range
INTERNAL = 10
EXTERNAL = 10
HZ = 10.0
WORLD = (100.0, 100.0)
SIGMAS = dict(dynamics=1.0, interrobot=0.005, obstacle=0.005, tracking=0.1)


def lanes_case(R=6, speed=10.0):
    """Parallel lanes closer than the safety distance: inter-robot factors
    active throughout, no crossing conflict — the well-conditioned regime."""
    starts, wpls, radii = [], [], []
    for i in range(R):
        lane = i % 3
        col = i // 3
        p0 = np.array([-40.0 + 6.0 * col, 2.8 * (lane - 1)])
        p1 = np.array([40.0 + 6.0 * col, 2.8 * (lane - 1)])
        v = np.array([speed, 0.0])
        starts.append(np.concatenate([p0, v]))
        wpls.append(np.stack([np.concatenate([p0, v]), np.concatenate([p1, v])]))
        radii.append(1.5)
    return np.array(starts), wpls, radii, speed


def circle_case(R=8, circle_radius=24.0, speed=10.0):
    starts, wpls, radii = [], [], []
    for i in range(R):
        ang = 2 * np.pi * i / R
        p0 = circle_radius * np.array([np.cos(ang), np.sin(ang)])
        p1 = -p0
        v = (p1 - p0) / np.linalg.norm(p1 - p0) * speed
        starts.append(np.concatenate([p0, v]))
        wpls.append(np.stack([np.concatenate([p0, v]), np.concatenate([p1, v])]))
        radii.append(1.5)
    return np.array(starts), wpls, radii, speed


def junction_case(R=6, speed=10.0):
    """Two crossing streams (the Junction Experiment geometry)."""
    starts, wpls, radii = [], [], []
    for i in range(R):
        k = i // 2
        if i % 2 == 0:
            p0 = np.array([-45.0, -4.0 * k])
            p1 = np.array([45.0, -4.0 * k])
        else:
            p0 = np.array([4.0 * k, 45.0])
            p1 = np.array([4.0 * k, -45.0])
        v = (p1 - p0) / np.linalg.norm(p1 - p0) * speed
        starts.append(np.concatenate([p0, v]))
        wpls.append(np.stack([np.concatenate([p0, v]), np.concatenate([p1, v])]))
        radii.append(1.5)
    return np.array(starts), wpls, radii, speed


# case -> (its maker, factors, chaotic, its least ticks), as the JAX
# harness's main runs them (the circle experiment's config disables
# tracking). The JAX harness runs lanes at least 80 ticks and the crossings
# --ticks, 60 by default. At 60 the circle is inside its finishing window:
# the oracle has 2 of 8 robots done at tick 55 and 8 at 60, and roundoff
# variants of the port's tick have 4 to 8 done at 60 and all 8 from tick 65
# on (scripts/torch_parity_spread.py; ROADMAP F14). So the circle runs at
# least 80 ticks, past every robot's finish; junction, all 6 done at 60 in
# every variant, runs --ticks as in the JAX harness.
CASES = {
    "lanes": (lanes_case, NO_TRK, False, 80),
    "circle": (circle_case, NO_TRK, True, 80),
    "junction": (junction_case, ALL_FACTORS, True, 0),
}
TICKS = 60
# A chaotic case's robots each finish within this many ticks of the
# oracle's robot. Over the eight roundoff variants of
# scripts/torch_parity_spread.py the widest shift is 11 ticks (junction's
# sixth robot, at tick 45 against the oracle's 56, in four variants) and
# the circle's 8; on top of that the window leaves 4 ticks for the card's
# summation order. A robot that stalls, or detours around a neighbour a
# wrong term misplaces, misses it.
COMPLETION_WINDOW_TICKS = 15


def build_case(starts, wpls, radii, speed, *, factors, dtype=torch.float64,
               device: torch.device | str = "cuda", use_pallas: bool | None = None):
    """(params, state, sdf) of a case: the dense side of
    tests/compare_util.build_pair as the parity harness calls it (horizon
    3 s, comms 250 m, 10 + 10 interleaved slots, K = R-1, no despawn, an
    all-ones 8x8 SDF), built with the port's GbpParams and init_state."""
    ts = get_variable_timesteps(int(speed * HORIZON_S), 3)
    V, R = len(ts), len(starts)
    sched = schedule_booleans(ScheduleKind.INTERLEAVE_EVENLY, INTERNAL, EXTERNAL)
    sdf_np = np.ones((8, 8))
    Wmax = max(len(w) for w in wpls)
    params = GbpParams(
        n_vars=V, n_slots=R - 1, max_waypoints=Wmax, schedule=tuple(sched),
        target_speed=speed, planning_horizon_seconds=HORIZON_S, comms_radius=COMMS_RADIUS,
        comms_failure_rate=0.0, hz=HZ, world_width=WORLD[0], world_height=WORLD[1],
        sdf_shape=sdf_np.shape, variable_timesteps=tuple(ts), dtype=dtype,
        sigma_factor_dynamics=SIGMAS["dynamics"], sigma_factor_interrobot=SIGMAS["interrobot"],
        sigma_factor_obstacle=SIGMAS["obstacle"], sigma_factor_tracking=SIGMAS["tracking"],
        dynamic_enabled="dynamic" in factors, interrobot_enabled="interrobot" in factors,
        obstacle_enabled="obstacle" in factors, tracking_enabled="tracking" in factors,
        despawn_on_final_waypoint=False, use_pallas=use_pallas,
    )
    wps = np.zeros((R, Wmax, 4))
    n_wps = np.zeros(R, dtype=np.int32)
    for r, wl in enumerate(wpls):
        wps[r, : len(wl)] = wl
        n_wps[r] = len(wl)
    radii = np.asarray(radii, dtype=np.float64)
    state = init_state(
        params, n_robots=R, start_states=np.asarray(starts), waypoints=wps,
        n_waypoints=n_wps, radii=radii, spawn_ticks=np.zeros(R, dtype=np.int32),
        variable_timesteps=np.array(ts), wp_check_var=np.full(R, V - 1, dtype=np.int32),
        wp_check_dist2=radii**2, fin_check_var=np.zeros(R, dtype=np.int32),
        fin_check_dist2=radii**2, device=device,
    )
    sdf = torch.as_tensor(sdf_np, dtype=dtype, device=state.device)
    return params, state, sdf


def trajectory(params, state, sdf, n_ticks: int) -> dict:
    """n_ticks of `tick.step`: the positions [T, R, 2] (float64) and
    completion flags [T, R] after each tick, and the final state. Asserts
    the degree held at R-1 (saturating connectivity) after every tick."""
    R = state.n_robots
    pos, done = [], []
    for _ in range(n_ticks):
        state = T.step(state, sdf, params)
        pos.append(state.pos.to(torch.float64).cpu().numpy())
        done.append(state.completed.cpu().numpy())
        deg = int(state.nbr_mask.sum(dim=1).min())
        if deg != R - 1:
            raise AssertionError(f"dense degree collapsed: {deg} != {R - 1}")
    return {"pos": np.stack(pos), "completed": np.stack(done), "state": state}


def completion_ticks(done: np.ndarray) -> list:
    """Each robot's completion tick (1-based: the tick after which its flag
    is first set) from flags [T, R], None where it never is."""
    first = done.argmax(axis=0)
    return [int(t) + 1 if done[t, r] else None for r, t in enumerate(first)]


def score(name: str, pos: np.ndarray, done: np.ndarray, ref_pos: np.ndarray,
          ref_done: np.ndarray, *, chaotic: bool, dtype: torch.dtype) -> dict:
    """The JAX harness's record of one case and its assertions, from the
    port's and the oracle's positions [T, R, 2] and flags [T, R]; a chaotic
    case also holds each robot's completion tick within
    COMPLETION_WINDOW_TICKS of the oracle's (a robot not done by the last
    tick counts as done on the next, its earliest)."""
    n_ticks, R = pos.shape[:2]
    d = np.linalg.norm(pos - ref_pos[:n_ticks], axis=-1)     # [T, R]
    err = d.max(axis=1)
    rmse = np.sqrt((d * d).sum(axis=0) / n_ticks)
    dense_done = int(done[-1].sum())
    oracle_done = int(ref_done[n_ticks - 1].sum())
    out = {
        "case": name,
        "regime": "chaotic" if chaotic else "well-conditioned",
        "robots": R,
        "ticks": n_ticks,
        "rmse_per_robot_m": [round(float(x), 12) for x in rmse],
        "rmse_max_m": float(rmse.max()),
        "divergence_curve_max_m": [round(float(e), 12) for e in err],
        "completed_dense": dense_done,
        "completed_oracle": oracle_done,
    }
    late = n_ticks + 1
    shift = [(a or late) - (b or late) for a, b in
             zip(completion_ticks(done), completion_ticks(ref_done[:n_ticks]))]
    print(
        f"{name} ({out['regime']}): R={R} RMSE(max over robots, {n_ticks} "
        f"ticks) = {rmse.max():.3e} m; final divergence {err[-1]:.3e} m; "
        f"completed dense={dense_done} oracle={oracle_done}; completion ticks "
        f"less the oracle's {shift}"
    )
    # stragglers can finish a few ticks apart between two implementations
    # of a chaotic case; +-1 at the tick budget is outcome parity
    if abs(dense_done - oracle_done) > (1 if chaotic else 0):
        raise AssertionError(f"qualitative outcome mismatch: {dense_done} != {oracle_done}")
    if chaotic and max(map(abs, shift)) > COMPLETION_WINDOW_TICKS:
        raise AssertionError(f"completion ticks off the oracle's by {shift}, past "
                             f"{COMPLETION_WINDOW_TICKS}")
    bound = RMSE_BOUND[dtype]
    if not chaotic and not rmse.max() < bound:
        raise AssertionError(f"RMSE {rmse.max():.3e} exceeds {bound:g} ({dtype})")
    return out


def load_reference(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def case_ticks(name: str, ticks: int = TICKS) -> int:
    """The ticks a case runs for a --ticks of `ticks`."""
    return max(ticks, CASES[name][3])


def run_case(name: str, n_ticks: int, *, reference: dict, dtype=torch.float64,
             device: torch.device | str = "cuda", use_pallas: bool | None = None) -> dict:
    """One case for `n_ticks` against the committed oracle trajectory."""
    make, factors, chaotic, _ = CASES[name]
    ref_pos, ref_done = reference[f"{name}_pos"], reference[f"{name}_completed"]
    if n_ticks > len(ref_pos):
        raise ValueError(f"{name}: {n_ticks} ticks asked, the reference holds {len(ref_pos)}")
    params, state, sdf = build_case(*make(), factors=factors, dtype=dtype, device=device,
                                    use_pallas=use_pallas)
    run = trajectory(params, state, sdf, n_ticks)
    return score(name, run["pos"], run["completed"], ref_pos, ref_done, chaotic=chaotic,
                 dtype=dtype)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ticks", type=int, default=TICKS,
                   help="ticks of the junction case; lanes and circle run at least 80")
    p.add_argument("--json", default=None, help="write the per-case records here")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="the card (the default; without one it raises) or the CPU")
    p.add_argument("--dtype", choices=list(DTYPES), default="float64")
    p.add_argument("--reference", default=DEFAULT_REFERENCE,
                   help="the oracle's trajectories (scripts/torch_oracle_reference.py)")
    return p


def main(argv=None) -> list[dict]:
    args = _parser().parse_args(argv)
    device = require_device(args.platform)
    dtype = DTYPES[args.dtype]
    reference = load_reference(args.reference)
    results = [run_case(name, case_ticks(name, args.ticks), reference=reference, dtype=dtype,
                        device=device) for name in CASES]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=1)
    well = [r for r in results if r["regime"] == "well-conditioned"]
    print(
        f"well-conditioned RMSE: {max(r['rmse_max_m'] for r in well):.3e} m "
        f"(target {RMSE_BOUND[dtype]:g}, {args.dtype})"
    )
    return results


if __name__ == "__main__":
    main()

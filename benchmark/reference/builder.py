"""Programmatic scenario construction (counterpart of magics_tpu's
sim/builder.py).

The numpy part is the JAX module's, copied because that module imports
`jax.numpy`; the result is the port's `GbpParams`, a `SimState` on `device`
(the card by default) and the SDF as a tensor on `device`. `ScheduleKind` is
re-exported for callers that build a schedule. Comms-failure draws need a
`torch.Generator` on the same device, made by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from benchmark.reference.schedule import ScheduleKind, schedule_booleans
from benchmark.reference.timesteps import get_variable_timesteps
from benchmark.reference.state import GbpParams, SimState, init_state, require_device


@dataclasses.dataclass
class RobotSpec:
    """One robot to spawn: initial pose and its waypoint state-vectors
    (field meanings as in magics_tpu sim/builder.py:RobotSpec)."""

    start: np.ndarray          # [4] = [x, y, vx, vy]
    waypoints: np.ndarray      # [W, 4] including the start pose as row 0
    radius: float = 1.0
    spawn_tick: int = 0
    wp_check_var: int = -1
    fin_check_var: int = 0
    wp_check_dist: float | None = None   # None -> robot radius
    fin_check_dist: float | None = None
    planning_strategy: str = "only-local"
    inflight: bool = False
    taskpoints: np.ndarray | None = None


def circle_formation(
    n_robots: int,
    circle_radius: float,
    target_speed: float,
    robot_radius: float = 2.0,
    center: tuple[float, float] = (0.0, 0.0),
) -> list[RobotSpec]:
    """The gbpplanner circle scenario: robots equally spaced on a circle, each
    crossing to the antipodal point."""
    specs = []
    for i in range(n_robots):
        ang = 2.0 * np.pi * i / n_robots
        p0 = np.array([center[0] + circle_radius * np.cos(ang),
                       center[1] + circle_radius * np.sin(ang)])
        p1 = np.array([center[0] + circle_radius * np.cos(ang + np.pi),
                       center[1] + circle_radius * np.sin(ang + np.pi)])
        d = p1 - p0
        v = d / np.linalg.norm(d) * target_speed
        start = np.concatenate([p0, v])
        wp = np.stack([start, np.concatenate([p1, v])])
        specs.append(RobotSpec(start=start, waypoints=wp, radius=robot_radius))
    return specs


def build_scenario(
    specs: Sequence[RobotSpec],
    *,
    target_speed: float,
    planning_horizon: float = 5.0,
    hz: float = 10.0,
    comms_radius: float = 20.0,
    comms_failure_rate: float = 0.0,
    internal: int = 10,
    external: int = 10,
    schedule: ScheduleKind = ScheduleKind.CENTERED,
    lookahead_multiple: int = 3,
    n_slots: int = 8,
    capacity: int | None = None,
    waypoint_capacity: int | None = None,
    sdf: np.ndarray | None = None,
    world: tuple[float, float] = (100.0, 100.0),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    goal_areas: np.ndarray | None = None,
    **param_overrides,
) -> tuple[GbpParams, SimState, torch.Tensor]:
    """Build (params, state, sdf) for a run, with the arguments of magics_tpu's
    `build_scenario` (`seed` aside: it seeded the JAX PRNG key) plus
    `device`, the card unless the caller asks for the CPU (without a card it
    raises). `use_pallas`, `ext_exchange`, `tracking_enabled` and the other
    GbpParams fields pass through `param_overrides`."""
    device = require_device(device)
    ts = get_variable_timesteps(int(target_speed * planning_horizon), lookahead_multiple)
    V = len(ts)
    R = capacity or len(specs)
    if R < len(specs):
        raise ValueError(f"capacity {R} < {len(specs)} robots")
    if sdf is None:
        sdf = np.ones((8, 8))
    Wmax = max(len(s.waypoints) for s in specs)
    if any(s.inflight for s in specs):
        Wmax = max(Wmax, waypoint_capacity or 64)
    elif waypoint_capacity:
        Wmax = max(Wmax, waypoint_capacity)

    param_overrides.setdefault(
        "max_robot_radius", float(max(s.radius for s in specs))
    )
    params = GbpParams(
        n_vars=V,
        n_slots=n_slots,
        max_waypoints=Wmax,
        schedule=tuple(schedule_booleans(schedule, internal, external)),
        target_speed=target_speed,
        planning_horizon_seconds=planning_horizon,
        comms_radius=comms_radius,
        comms_failure_rate=comms_failure_rate,
        hz=hz,
        world_width=world[0],
        world_height=world[1],
        sdf_shape=tuple(sdf.shape),
        variable_timesteps=tuple(ts),
        dtype=dtype,
        **param_overrides,
    )

    starts = np.zeros((R, 4))
    wps = np.zeros((R, Wmax, 4))
    n_wps = np.zeros(R, dtype=np.int32)
    radii = np.ones(R)
    spawn = np.full(R, -1, dtype=np.int32)
    wp_var = np.full(R, V - 1, dtype=np.int32)
    fin_var = np.zeros(R, dtype=np.int32)
    wp_d2 = np.ones(R)
    fin_d2 = np.ones(R)
    for i, s in enumerate(specs):
        starts[i] = s.start
        wps[i, : len(s.waypoints)] = s.waypoints
        n_wps[i] = len(s.waypoints)
        radii[i] = s.radius
        spawn[i] = s.spawn_tick
        wp_var[i] = (V - 1) if s.wp_check_var == -1 else s.wp_check_var
        fin_var[i] = (V - 1) if s.fin_check_var == -1 else s.fin_check_var
        wp_d2[i] = (s.wp_check_dist if s.wp_check_dist is not None else s.radius) ** 2
        fin_d2[i] = (s.fin_check_dist if s.fin_check_dist is not None else s.radius) ** 2

    pending = np.array([s.inflight for s in specs] + [False] * (R - len(specs)))

    state = init_state(
        params,
        n_robots=R,
        start_states=starts,
        waypoints=wps,
        n_waypoints=n_wps,
        radii=radii,
        spawn_ticks=spawn,
        variable_timesteps=np.array(ts),
        wp_check_var=wp_var,
        wp_check_dist2=wp_d2,
        fin_check_var=fin_var,
        fin_check_dist2=fin_d2,
        device=device,
        goal_areas=goal_areas,
        plan_pending=pending,
    )
    return params, state, torch.as_tensor(np.asarray(sdf), device=device).to(dtype)

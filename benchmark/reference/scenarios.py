"""The reference's own derivation of each configuration's run: robots,
waypoints, parameters, SDF and environment distances, worked out from the
configuration file alone (nothing the program built is read here)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.builder import RobotSpec, build_scenario
from benchmark.reference.schedule import ScheduleKind

#: the environment distance of an empty map: no obstacle within reach, so no
#: robot ever overlaps the environment
FAR = 1e9


def circle_offset(cfg: dict, seed: int) -> tuple[float, float]:
    """The seed's shift of the formation's centre, in metres, (dx, dy) each
    uniform in +-`seed_shift_m` (the port's circle formation places robot 0
    at angle 0 and takes no turn, so the seed moves the circle instead)."""
    rng = np.random.default_rng(seed)
    s = cfg["seed_shift_m"]
    dx, dy = rng.uniform(-s, s, 2)
    return float(dx), float(dy)


def swarm_turn(seed: int) -> float:
    """The seed's turn of the swarm's ring about its centre, in radians."""
    return float(np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi))


def circle_goals(cfg: dict, robots: int, seed: int) -> np.ndarray:
    """[robots, 2]: each robot's goal, the point of the seed's circle
    opposite its start (robot i starts at angle 2 pi i / robots)."""
    dx, dy = circle_offset(cfg, seed)
    r = cfg["formation"]["circle_radius"]
    a = 2.0 * np.pi * np.arange(robots) / robots + np.pi
    return np.stack([dx + r * np.cos(a), dy + r * np.sin(a)], axis=-1)


def _poses(chain: list, speed: float) -> np.ndarray:
    """Each pose points at the next waypoint at target speed; the last
    copies the second last's velocity (spawner.rs:470-500)."""
    poses = []
    for a, b in zip(chain, chain[1:] + [chain[-1]]):
        d = np.asarray(b) - np.asarray(a)
        n = np.linalg.norm(d)
        v = d / n * speed if n > 0 else np.zeros(2)
        poses.append(np.concatenate([a, v]))
    poses[-1][2:] = poses[-2][2:]
    return np.stack(poses)


def circle_experiment(cfg: dict, robots: int, seed: int, *, viz_log: bool,
                      dtype=torch.float64, device="cuda"):
    """(params, state, sdf, env_dist) of the Circle Experiment with `robots`
    robots equally spaced on the circle, each crossing to the opposite
    point, in an empty square tile, as the configuration states it."""
    sim, gbp, robot = cfg["toml"]["simulation"], cfg["toml"]["gbp"], cfg["toml"]["robot"]
    form, tile = cfg["formation"], cfg["environment"]["tile_size"]
    hz, speed = sim["hz"], robot["target-speed"]
    dx, dy = circle_offset(cfg, seed)
    r = form["circle_radius"]
    specs = []
    for i in range(robots):
        a = 2.0 * math.pi * i / robots
        start = np.array([dx + r * math.cos(a), dy + r * math.sin(a)])
        goal = np.array([dx + r * math.cos(a + math.pi), dy + r * math.sin(a + math.pi)])
        poses = _poses([start, goal], speed)
        specs.append(RobotSpec(start=poses[0], waypoints=poses, radius=robot["radius"]["min"],
                               spawn_tick=0, wp_check_var=-1, fin_check_var=0))
    max_ticks = int(sim["max-time"] * hz)
    sched, enabled, trk = gbp["iteration-schedule"], gbp["factors-enabled"], gbp["tracking"]
    comm = robot["communication"]
    res = cfg["environment"]["sdf_resolution"]
    sdf = np.ones((res, res))
    params, state, sdf_t = build_scenario(
        specs, target_speed=speed, planning_horizon=robot["planning-horizon"], hz=hz,
        comms_radius=comm["radius"], comms_failure_rate=comm["failure-rate"],
        internal=sched["internal"], external=sched["external"],
        schedule=ScheduleKind(sched["schedule"]), lookahead_multiple=gbp["lookahead-multiple"],
        n_slots=max(1, min(robots - 1, 128)), sdf=sdf, world=(tile, tile), dtype=dtype,
        device=device,
        sigma_factor_dynamics=gbp["sigma-factor-dynamics"],
        sigma_factor_interrobot=gbp["sigma-factor-interrobot"],
        sigma_factor_obstacle=gbp["sigma-factor-obstacle"],
        sigma_factor_tracking=gbp["sigma-factor-tracking"],
        tracking_switch_padding=trk["switch-padding"],
        tracking_attraction_distance=trk["attraction-distance"],
        dynamic_enabled=enabled["dynamic"], interrobot_enabled=enabled["interrobot"],
        obstacle_enabled=enabled["obstacle"], tracking_enabled=enabled["tracking"],
        despawn_on_final_waypoint=sim["despawn-robot-when-final-waypoint-reached"],
        safety_distance_multiplier=robot["inter-robot-safety-distance-multiplier"],
        log_every=max(1, round(0.1 * hz)), log_capacity=min(max_ticks, 10_000),
        collision_log_capacity=256 if robots <= 256 else 0,
        viz_log_capacity=min(max_ticks // max(1, round(0.1 * hz)) + 1, 2000) if viz_log else 0,
    )
    env_dist = torch.full((res, res), FAR, dtype=dtype, device=device)
    return params, state, sdf_t, env_dist


def swarm(cfg: dict, seed: int, *, dtype=torch.float64, device="cuda"):
    """(params, state, sdf) of the swarm: R robots 4.9 m apart on a circle
    (radius at least 200 m), turned about its centre by the seed's angle,
    each crossing to the opposite point, in a square world 2.6 times the
    radius with an all-free SDF."""
    R, speed = cfg["robots"], cfg["target_speed"]
    radius = max(cfg["min_circle_radius"], R * cfg["spacing_m"] / (2 * math.pi))
    world = cfg["world_over_radius"] * radius
    turn = swarm_turn(seed)
    specs = []
    for i in range(R):
        a = turn + 2.0 * math.pi * i / R
        p0 = np.array([radius * math.cos(a), radius * math.sin(a)])
        p1 = np.array([radius * math.cos(a + math.pi), radius * math.sin(a + math.pi)])
        v = (p1 - p0) / np.linalg.norm(p1 - p0) * speed
        start = np.concatenate([p0, v])
        specs.append(RobotSpec(start=start, waypoints=np.stack([start, np.concatenate([p1, v])]),
                               radius=cfg["robot_radius"]))
    res = cfg["sdf_resolution"]
    return build_scenario(
        specs, target_speed=speed, planning_horizon=cfg["planning_horizon"], hz=cfg["hz"],
        comms_radius=cfg["comms_radius"], internal=cfg["internal"], external=cfg["external"],
        schedule=ScheduleKind(cfg["schedule"]), n_slots=cfg["n_slots"],
        world=(world, world), sdf=np.ones((res, res)), dtype=dtype, device=device,
        despawn_on_final_waypoint=cfg["despawn_on_final_waypoint"],
        tracking_enabled=cfg["tracking_enabled"], ext_exchange=cfg["ext_exchange"],
        grid_cell_size=cfg["grid_cell_size"], grid_capacity=cfg["grid_capacity"],
        collision_partners=cfg["collision_partners"],
    )

"""The program's side of each configuration: the inputs the benchmark hands
to magics_tpu_torch, built from the configuration file and the seed by the
program's own entry points (a Scenario for the Simulator, RobotSpecs for
`build_scenario`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.scenarios import circle_offset, swarm_turn


def circle_scenario(cfg: dict, seed: int):
    """The Circle Experiment as a Scenario (the configuration's TOML table,
    a formation document and an empty environment built in memory), its
    circle shifted by the seed."""
    from magics_tpu_torch.config.formation import Formation, FormationGroup
    from magics_tpu_torch.config.loader import Scenario
    from magics_tpu_torch.config.schema import Config
    from magics_tpu_torch.env.model import Environment, SdfSettings

    env_cfg, form = cfg["environment"], cfg["formation"]
    tile = env_cfg["tile_size"]
    dx, dy = circle_offset(cfg, seed)
    circle = {"circle": {"radius": form["circle_radius"],
                         "center": {"x": 0.5 + dx / tile, "y": 0.5 + dy / tile}}}
    formation = Formation.parse({
        "robots": form["robots"],
        "initial-position": {"shape": circle, "placement-strategy": form["placement"]},
        "waypoints": [{"shape": circle, "projection-strategy": "cross"}],
        "finished-when-intersects": {"intersects-with": form["finished_when"]},
    })
    env = Environment(grid=list(env_cfg["grid"]), tile_size=tile,
                      path_width=env_cfg["path_width"],
                      sdf=SdfSettings(resolution=env_cfg["sdf_resolution"],
                                      expansion=env_cfg["sdf_expansion"],
                                      blur=env_cfg["sdf_blur"]))
    return Scenario(name="Circle Experiment", config=Config.parse(cfg["toml"]),
                    environment=env, formations=FormationGroup([formation]))


def swarm_scenario(cfg: dict, seed: int, device="cuda"):
    """(params, state, sdf) of the swarm through the program's
    `build_scenario`: the ring turned by the seed's angle."""
    from magics_tpu_torch.core.schedule import ScheduleKind
    from magics_tpu_torch.sim.builder import RobotSpec, build_scenario

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
        world=(world, world), sdf=np.ones((res, res)), dtype=getattr(torch, cfg["dtype"]),
        device=device, despawn_on_final_waypoint=cfg["despawn_on_final_waypoint"],
        tracking_enabled=cfg["tracking_enabled"], ext_exchange=cfg["ext_exchange"],
        grid_cell_size=cfg["grid_cell_size"], grid_capacity=cfg["grid_capacity"],
        collision_partners=cfg["collision_partners"],
    )

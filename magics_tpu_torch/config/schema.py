"""The scenario `config.toml` schema.

Mirrors the reference's `gbp_config` crate (crates/gbp_config/src/lib.rs:
797-895 and the sections it references), with the same kebab-case keys and
defaults, so the shipped scenario files parse unchanged. Visualisation-only
sections are parsed permissively and retained as raw dicts (they do not
affect a headless simulation).
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import Any

from magics_tpu_torch.core.schedule import ScheduleKind


@dataclasses.dataclass
class GbpIterationSchedule:
    # crates/gbp_config/src/lib.rs:407-426
    internal: int = 10
    external: int = 10
    schedule: ScheduleKind = ScheduleKind.CENTERED

    @classmethod
    def parse(cls, d: dict) -> "GbpIterationSchedule":
        return cls(
            internal=int(d.get("internal", 10)),
            external=int(d.get("external", 10)),
            schedule=ScheduleKind(str(d.get("schedule", "centered"))),
        )


@dataclasses.dataclass
class FactorsEnabled:
    # crates/gbp_config/src/lib.rs:454-494
    dynamic: bool = True
    interrobot: bool = True
    obstacle: bool = True
    tracking: bool = False

    @classmethod
    def parse(cls, d: dict) -> "FactorsEnabled":
        return cls(
            dynamic=bool(d.get("dynamic", True)),
            interrobot=bool(d.get("interrobot", True)),
            obstacle=bool(d.get("obstacle", True)),
            tracking=bool(d.get("tracking", False)),
        )


@dataclasses.dataclass
class TrackingSection:
    # crates/gbp_config/src/lib.rs:500-537
    switch_padding: float = 1.0
    attraction_distance: float = 2.0

    @classmethod
    def parse(cls, d: dict) -> "TrackingSection":
        return cls(
            switch_padding=float(d.get("switch-padding", 1.0)),
            attraction_distance=float(d.get("attraction-distance", 2.0)),
        )


@dataclasses.dataclass
class GbpSection:
    # crates/gbp_config/src/lib.rs:544-594
    sigma_pose_fixed: float = 1e-15
    sigma_factor_dynamics: float = 0.1
    sigma_factor_interrobot: float = 0.01
    sigma_factor_obstacle: float = 0.01
    sigma_factor_tracking: float = 0.1
    lookahead_multiple: int = 3
    variables: int = 10
    tracking: TrackingSection = dataclasses.field(default_factory=TrackingSection)
    iteration_schedule: GbpIterationSchedule = dataclasses.field(
        default_factory=GbpIterationSchedule
    )
    factors_enabled: FactorsEnabled = dataclasses.field(default_factory=FactorsEnabled)

    @classmethod
    def parse(cls, d: dict) -> "GbpSection":
        return cls(
            sigma_pose_fixed=float(d.get("sigma-pose-fixed", 1e-15)),
            sigma_factor_dynamics=float(d.get("sigma-factor-dynamics", 0.1)),
            sigma_factor_interrobot=float(d.get("sigma-factor-interrobot", 0.01)),
            sigma_factor_obstacle=float(d.get("sigma-factor-obstacle", 0.01)),
            sigma_factor_tracking=float(d.get("sigma-factor-tracking", 0.1)),
            lookahead_multiple=int(d.get("lookahead-multiple", 3)),
            variables=int(d.get("variables", 10)),
            tracking=TrackingSection.parse(d.get("tracking", {})),
            iteration_schedule=GbpIterationSchedule.parse(
                d.get("iteration-schedule", {})
            ),
            factors_enabled=FactorsEnabled.parse(d.get("factors-enabled", {})),
        )


@dataclasses.dataclass
class CommunicationSection:
    # crates/gbp_config/src/lib.rs:601-624
    radius: float = 20.0
    failure_rate: float = 0.2

    @classmethod
    def parse(cls, d: dict) -> "CommunicationSection":
        return cls(
            radius=float(d.get("radius", 20.0)),
            failure_rate=float(d.get("failure-rate", 0.2)),
        )


@dataclasses.dataclass
class RobotRadiusSection:
    min: float = 1.0
    max: float = 1.0

    @classmethod
    def parse(cls, d: dict) -> "RobotRadiusSection":
        if isinstance(d, (int, float)):
            return cls(min=float(d), max=float(d))
        return cls(min=float(d.get("min", 1.0)), max=float(d.get("max", 1.0)))


@dataclasses.dataclass
class RobotSection:
    # crates/gbp_config/src/lib.rs:651-682
    planning_horizon: float = 5.0
    target_speed: float = 4.0
    radius: RobotRadiusSection = dataclasses.field(default_factory=RobotRadiusSection)
    communication: CommunicationSection = dataclasses.field(
        default_factory=CommunicationSection
    )
    inter_robot_safety_distance_multiplier: float = 2.2

    @classmethod
    def parse(cls, d: dict) -> "RobotSection":
        return cls(
            planning_horizon=float(d.get("planning-horizon", 5.0)),
            target_speed=float(d.get("target-speed", 4.0)),
            radius=RobotRadiusSection.parse(d.get("radius", {})),
            communication=CommunicationSection.parse(d.get("communication", {})),
            inter_robot_safety_distance_multiplier=float(
                d.get("inter-robot-safety-distance-multiplier", 2.2)
            ),
        )


@dataclasses.dataclass
class SimulationSection:
    # crates/gbp_config/src/lib.rs:286-350
    max_time: float = 10000.0
    time_scale: float = 1.0
    manual_step_factor: int = 1
    hz: float = 60.0
    prng_seed: int = 0
    pause_on_spawn: bool = False
    despawn_robot_when_final_waypoint_reached: bool = True
    exit_application_on_scenario_finished: bool = False

    @classmethod
    def parse(cls, d: dict) -> "SimulationSection":
        return cls(
            max_time=float(d.get("max-time", 10000.0)),
            time_scale=float(d.get("time-scale", 1.0)),
            manual_step_factor=int(d.get("manual-step-factor", 1)),
            hz=float(d.get("hz", 60.0)),
            prng_seed=int(d.get("prng-seed", 0)),
            pause_on_spawn=bool(d.get("pause-on-spawn", False)),
            despawn_robot_when_final_waypoint_reached=bool(
                d.get("despawn-robot-when-final-waypoint-reached", True)
            ),
            exit_application_on_scenario_finished=bool(
                d.get("exit-application-on-scenario-finished", False)
            ),
        )


@dataclasses.dataclass
class RrtSection:
    # crates/gbp_config/src/lib.rs:708-757
    max_iterations: int = 10_000
    step_size: float = 5.0
    collision_radius: float = 3.0
    neighbourhood_radius: float = 8.0
    smoothing_enabled: bool = True
    smoothing_max_iterations: int = 500
    smoothing_step_size: float = 0.5

    @classmethod
    def parse(cls, d: dict) -> "RrtSection":
        sm = d.get("smoothing", {}) or {}
        return cls(
            max_iterations=int(d.get("max-iterations", 10_000)),
            step_size=float(d.get("step-size", 5.0)),
            collision_radius=float(d.get("collision-radius", 3.0)),
            neighbourhood_radius=float(d.get("neighbourhood-radius", 8.0)),
            smoothing_enabled=bool(sm.get("enabled", True)),
            smoothing_max_iterations=int(sm.get("max-iterations", 500)),
            smoothing_step_size=float(sm.get("step-size", 0.5)),
        )


@dataclasses.dataclass
class Config:
    """The full scenario config (crates/gbp_config/src/lib.rs:797-895)."""

    environment: str = ""
    environment_image: str = ""
    formation_group: str = ""
    gbp: GbpSection = dataclasses.field(default_factory=GbpSection)
    robot: RobotSection = dataclasses.field(default_factory=RobotSection)
    simulation: SimulationSection = dataclasses.field(default_factory=SimulationSection)
    rrt: RrtSection = dataclasses.field(default_factory=RrtSection)
    # parsed permissively; headless sim ignores them but round-trips the data
    visualisation: dict = dataclasses.field(default_factory=dict)
    interaction: dict = dataclasses.field(default_factory=dict)
    manual: dict = dataclasses.field(default_factory=dict)
    graphviz: dict = dataclasses.field(default_factory=dict)
    debug: dict = dataclasses.field(default_factory=dict)
    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def parse(cls, d: dict[str, Any]) -> "Config":
        return cls(
            environment=str(d.get("environment", "")),
            environment_image=str(d.get("environment_image", d.get("environment-image", ""))),
            formation_group=str(d.get("formation_group", d.get("formation-group", ""))),
            gbp=GbpSection.parse(d.get("gbp", {})),
            robot=RobotSection.parse(d.get("robot", {})),
            simulation=SimulationSection.parse(d.get("simulation", {})),
            rrt=RrtSection.parse(d.get("rrt", {})),
            visualisation=d.get("visualisation", {}),
            interaction=d.get("interaction", {}),
            manual=d.get("manual", {}),
            graphviz=d.get("graphviz", {}),
            debug=d.get("debug", {}),
            raw=d,
        )

    @classmethod
    def from_toml(cls, text: str) -> "Config":
        return cls.parse(tomllib.loads(text))

    @classmethod
    def from_file(cls, path) -> "Config":
        with open(path, "rb") as f:
            return cls.parse(tomllib.load(f))


# ---------------------------------------------------------------------------
# TOML round-trip (the reference's save_settings, simulation_loader.rs:742-763:
# the live Config is serialised back to the scenario's config.toml)
# ---------------------------------------------------------------------------

def _toml_scalar(v) -> str:
    import json as _json

    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        s = repr(v)
        return s if ("." in s or "e" in s or "E" in s or "inf" in s or "nan" in s) else s + ".0"
    if isinstance(v, str):
        return _json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_scalar(x) for x in v) + "]"
    raise TypeError(f"cannot serialise {type(v)} to TOML")


def dumps_toml(d: dict, _prefix: str = "") -> str:
    """Minimal TOML emitter (scalars/arrays + nested tables) — enough for the
    Config schema; the stdlib only ships a reader."""
    lines: list[str] = []
    tables: list[tuple[str, dict]] = []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{k} = {_toml_scalar(v)}")
    out = "\n".join(lines)
    for k, v in tables:
        name = f"{_prefix}{k}"
        body = dumps_toml(v, _prefix=name + ".")
        out += f"\n\n[{name}]\n{body}" if body else f"\n\n[{name}]"
    return out.strip() + "\n" if (lines or tables) else ""


def _config_to_dict(cfg: "Config") -> dict:
    """Current typed values in the kebab-case TOML layout, merged over the
    raw document so permissively-parsed sections round-trip unchanged."""
    import copy

    d = copy.deepcopy(cfg.raw) if cfg.raw else {}
    d["environment"] = cfg.environment
    if cfg.environment_image:
        d["environment_image"] = cfg.environment_image
    if cfg.formation_group:
        d["formation_group"] = cfg.formation_group
    g = d.setdefault("gbp", {})
    g["sigma-pose-fixed"] = cfg.gbp.sigma_pose_fixed
    g["sigma-factor-dynamics"] = cfg.gbp.sigma_factor_dynamics
    g["sigma-factor-interrobot"] = cfg.gbp.sigma_factor_interrobot
    g["sigma-factor-obstacle"] = cfg.gbp.sigma_factor_obstacle
    g["sigma-factor-tracking"] = cfg.gbp.sigma_factor_tracking
    g["lookahead-multiple"] = cfg.gbp.lookahead_multiple
    g["variables"] = cfg.gbp.variables
    g.setdefault("tracking", {}).update(
        {
            "switch-padding": cfg.gbp.tracking.switch_padding,
            "attraction-distance": cfg.gbp.tracking.attraction_distance,
        }
    )
    g.setdefault("iteration-schedule", {}).update(
        {
            "internal": cfg.gbp.iteration_schedule.internal,
            "external": cfg.gbp.iteration_schedule.external,
            "schedule": cfg.gbp.iteration_schedule.schedule.value,
        }
    )
    g.setdefault("factors-enabled", {}).update(
        {
            "dynamic": cfg.gbp.factors_enabled.dynamic,
            "interrobot": cfg.gbp.factors_enabled.interrobot,
            "obstacle": cfg.gbp.factors_enabled.obstacle,
            "tracking": cfg.gbp.factors_enabled.tracking,
        }
    )
    r = d.setdefault("robot", {})
    r["planning-horizon"] = cfg.robot.planning_horizon
    r["target-speed"] = cfg.robot.target_speed
    r["inter-robot-safety-distance-multiplier"] = (
        cfg.robot.inter_robot_safety_distance_multiplier
    )
    r["radius"] = {"min": cfg.robot.radius.min, "max": cfg.robot.radius.max}
    r.setdefault("communication", {}).update(
        {
            "radius": cfg.robot.communication.radius,
            "failure-rate": cfg.robot.communication.failure_rate,
        }
    )
    s = d.setdefault("simulation", {})
    s["max-time"] = cfg.simulation.max_time
    s["time-scale"] = cfg.simulation.time_scale
    s["manual-step-factor"] = cfg.simulation.manual_step_factor
    s["hz"] = cfg.simulation.hz
    s["prng-seed"] = cfg.simulation.prng_seed
    s["pause-on-spawn"] = cfg.simulation.pause_on_spawn
    s["despawn-robot-when-final-waypoint-reached"] = (
        cfg.simulation.despawn_robot_when_final_waypoint_reached
    )
    s["exit-application-on-scenario-finished"] = (
        cfg.simulation.exit_application_on_scenario_finished
    )
    t = d.setdefault("rrt", {})
    t["max-iterations"] = cfg.rrt.max_iterations
    t["step-size"] = cfg.rrt.step_size
    t["collision-radius"] = cfg.rrt.collision_radius
    t["neighbourhood-radius"] = cfg.rrt.neighbourhood_radius
    t.setdefault("smoothing", {}).update(
        {
            "enabled": cfg.rrt.smoothing_enabled,
            "max-iterations": cfg.rrt.smoothing_max_iterations,
            "step-size": cfg.rrt.smoothing_step_size,
        }
    )
    return d


def config_to_toml(cfg: "Config") -> str:
    """Serialise the live Config back to TOML (save_settings parity)."""
    return dumps_toml(_config_to_dict(cfg))

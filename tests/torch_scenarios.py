"""Scenario directories for the tests of the port's surfaces (the CLI, the
live view, the renderers): `config.toml` and `environment.yaml` /
`formation.yaml` written as JSON documents by the port's
`config.dump.json_yaml`, so both packages' loaders read them, the port's
without PyYAML. 8 robots on line segments, random placement (no exact
distance ties, ROADMAP F2), a small obstacle, a few seconds of sim time."""

from __future__ import annotations

from pathlib import Path

from magics_tpu_torch.config.dump import json_yaml

TOML = """
[simulation]
hz = 10.0
prng-seed = {seed}
max-time = {max_time}
despawn-robot-when-final-waypoint-reached = false

[gbp]
sigma-factor-interrobot = 0.005
lookahead-multiple = 3
[gbp.iteration-schedule]
internal = 4
external = 2
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


def segment(x0, y0, x1, y1):
    return {"line-segment": [{"x": x0, "y": y0}, {"x": x1, "y": y1}]}


def formations(robots: int) -> dict:
    """Two groups crossing each other: `robots - 4` top to bottom, 4 more
    left to right, half a second later."""
    return {"formations": [
        {
            "robots": robots - 4,
            "initial-position": {"shape": segment(0.3, 0.1, 0.7, 0.1),
                                 "placement-strategy": "random"},
            "waypoints": [{"shape": segment(0.3, 0.9, 0.7, 0.9),
                           "projection-strategy": "identity"}],
            "finished-when-intersects": {"distance": 3.0, "intersects-with": "current"},
        },
        {
            "robots": 4,
            "delay": {"secs": 0, "nanos": 500_000_000},
            "initial-position": {"shape": segment(0.1, 0.3, 0.1, 0.7),
                                 "placement-strategy": "random"},
            "waypoints": [{"shape": segment(0.9, 0.3, 0.9, 0.7),
                           "projection-strategy": "cross"}],
        },
    ]}


def environment(tile: float) -> dict:
    """One open tile with a small circular obstacle off the crossing's
    centre; its rotation, 1e-05, is a float that `json.dumps` would write as
    a string to PyYAML."""
    return {
        "tiles": {
            "grid": ["█"],
            "settings": {"tile-size": tile, "path-width": 0.1325, "obstacle-height": 1.0,
                         "sdf": {"resolution": 60, "expansion": 0.1, "blur": 0.01}},
        },
        "obstacles": [{
            "shape": {"circle": {"radius": 0.04}},
            "rotation": 1e-05,
            "translation": {"x": 0.62, "y": 0.45},
            "tile-coordinates": {"row": 0, "col": 0},
        }],
    }


def write_scenario(root: Path, name: str, *, robots: int = 8, seed: int = 31,
                   max_time: float = 4.0, tile: float = 70.0) -> Path:
    d = Path(root) / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(TOML.format(seed=seed, max_time=max_time))
    (d / "environment.yaml").write_text(json_yaml(environment(tile)))
    (d / "formation.yaml").write_text(json_yaml(formations(robots)))
    return d

"""Built-in environments (gbp_environment/src/lib.rs:784-960 parity).

The reference ships six named environment presets selectable via
`--dump-environment <type>` (cli.rs); these are declarative data (tile grids
+ obstacle placements), reproduced here through the same DSL.
"""

from __future__ import annotations

import math

from magics_tpu_torch.env.model import (
    Circle,
    Environment,
    Obstacle,
    Rectangle,
    RegularPolygon,
    SdfSettings,
    Triangle,
)


def _env(grid, tile_size, path_width, obstacles=()):
    return Environment(
        grid=list(grid),
        tile_size=tile_size,
        path_width=path_width,
        obstacle_height=1.0,
        sdf=SdfSettings(),
        obstacles=list(obstacles),
    )


def intersection() -> Environment:
    return _env(["┼"], 100.0, 0.1325)


def intermediate() -> Environment:
    return _env(["┌┬┐ ", "┘└┼┬", "  └┘"], 50.0, 0.1325)


def complex_env() -> Environment:
    return _env(
        ["┌─┼─┬─┐┌", "┼─┘┌┼┬┼┘", "┴┬─┴┼┘│ ", "┌┴┐┌┼─┴┬", "├─┴┘└──┘"],
        25.0,
        0.4,
    )


def maze() -> Environment:
    return _env(
        [
            "               ",
            " ╶─┬─┐┌─────┬┐ ",
            " ┌─┤┌┤│╷╶──┬┘│ ",
            " │╷│╵├┤├─┬┬┴┬┤ ",
            " └┤├─┘││╷╵├─┘│ ",
            " ╷│╵╷╶┤│├┐└╴┌┘ ",
            " │├─┴╴│╵│└──┤╷ ",
            " └┤┌─┐└┬┘┌─┐└┘ ",
            " ┌┴┤╷├╴│┌┤╷└─┐ ",
            " │┌┤├┘┌┘││└──┤ ",
            " ╵│╵├┬┘┌┘└──┐╵ ",
            " ┌┘╶┘├─┴─┐╷╷└┐ ",
            " └─┬─┴──┐├┘├─┘ ",
            " ┌┐│╷┌─╴││╶┘╶┐ ",
            " │└┼┘├──┘├──┬┤ ",
            " ╵╶┴─┘╶──┴──┴┘ ",
            "               ",
        ],
        10.0,
        0.75,
    )


def test_env() -> Environment:
    return _env(["┌┬┐├", "└┴┘┤", "│─ ┼", "╴╵╶╷"], 50.0, 0.1325)


def circle() -> Environment:
    """An open field of scattered obstacles (lib.rs:900-960)."""
    obstacles = [
        Obstacle(tile=(0, 0), shape=RegularPolygon(4, 0.0525), rotation=0.0,
                 translation=(0.625, 0.60125)),
        Obstacle(tile=(0, 0), shape=RegularPolygon(4, 0.035), rotation=0.0,
                 translation=(0.44125, 0.57125)),
        Obstacle(tile=(0, 0), shape=RegularPolygon(4, 0.0225), rotation=0.0,
                 translation=(0.4835, 0.428)),
        Obstacle(tile=(0, 0), shape=Rectangle(0.0875, 0.035), rotation=0.0,
                 translation=(0.589, 0.3965)),
        Obstacle(tile=(0, 0),
                 shape=Triangle(math.radians(30.0), math.radians(30.0), 0.05),
                 rotation=0.0, translation=(0.5575, 0.5145)),
        Obstacle(tile=(0, 0),
                 shape=Triangle(math.radians(40.0), math.radians(40.0), 0.03),
                 rotation=0.4, translation=(0.38, 0.432)),
        Obstacle(tile=(0, 0), shape=Circle(0.065), rotation=0.0,
                 translation=(0.4425, 0.28575)),
    ]
    return _env(["█"], 100.0, 0.0, obstacles)


BUILTINS = {
    "intersection": intersection,
    "intermediate": intermediate,
    "complex": complex_env,
    "circle": circle,
    "maze": maze,
    "test": test_env,
}

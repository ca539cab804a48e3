"""World-space obstacle geometry export (export.rs:264-270,500-549 parity).

The reference exports its parry2d colliders as tagged Circle/Polygon records.
Here the same geometry is derived from the declarative environment: placeable
obstacles map directly; the tile-grid wall bands (the obstacle regions each
box-drawing character carves out, env_to_png lib.rs:341-478 — see
magics_tpu/env/sdf.py:_tile_obstacle) are emitted as axis-aligned rectangle
polygons per tile.
"""

from __future__ import annotations

import math

import numpy as np

from magics_tpu_torch.env.model import (
    Circle,
    Environment,
    Polygon,
    Rectangle,
    RegularPolygon,
    Triangle,
)


def _tile_rects(ch: str, pw: float) -> list[tuple[float, float, float, float]]:
    """Obstacle bands of one tile char in tile-relative coords (x0,y0,x1,y1),
    y measured downward from the tile's top edge. Mirrors _tile_obstacle."""
    ow = (1.0 - pw) / 2.0
    opw = ow + pw
    top = (0.0, 0.0, 1.0, ow)        # py < ow
    bottom = (0.0, opw, 1.0, 1.0)    # py > opw
    left = (0.0, 0.0, ow, 1.0)       # px < ow
    right = (opw, 0.0, 1.0, 1.0)     # px > opw
    tl = (0.0, 0.0, ow, ow)
    tr = (opw, 0.0, 1.0, ow)
    bl = (0.0, opw, ow, 1.0)
    br = (opw, opw, 1.0, 1.0)
    half_r = (0.5, 0.0, 1.0, 1.0)    # px > 0.5
    half_l = (0.0, 0.0, 0.5, 1.0)
    half_b = (0.0, 0.5, 1.0, 1.0)    # py > 0.5
    half_t = (0.0, 0.0, 1.0, 0.5)

    table = {
        "█": [],
        "─": [top, bottom],
        "│": [left, right],
        "╴": [top, bottom, half_r],
        "╶": [top, bottom, half_l],
        "╷": [left, right, half_t],
        "╵": [left, right, half_b],
        "┌": [left, top, br],
        "┐": [right, top, bl],
        "└": [left, bottom, tr],
        "┘": [right, bottom, tl],
        "┬": [top, bl, br],
        "┴": [bottom, tl, tr],
        "├": [left, tr, br],
        "┤": [right, tl, bl],
        "┼": [tl, tr, bl, br],
        " ": [(0.0, 0.0, 1.0, 1.0)],
    }
    return table.get(ch, [])


def export_obstacles(env: Environment) -> dict:
    """Tagged obstacle records keyed by a synthetic id (the reference keys by
    Entity): {"type": "Circle", center, radius} | {"type": "Polygon",
    vertices}. All coordinates are world-space (origin center, y up)."""
    ww, wh = env.world_size
    nrows, ncols = env.nrows, env.ncols
    tile = env.tile_size
    out: dict[str, dict] = {}
    n = 0

    def to_world(c, r, px, py):
        """tile (col c, row r) + tile-relative (px, py; py down) -> world."""
        return (
            (c + px) * tile - ww / 2.0,
            wh / 2.0 - (r + py) * tile,
        )

    # tile-grid walls
    for r, row in enumerate(env.grid):
        for c, ch in enumerate(row):
            for x0, y0, x1, y1 in _tile_rects(ch, env.path_width):
                ax, ay = to_world(c, r, x0, y0)
                bx, by = to_world(c, r, x1, y1)
                out[str(n)] = {
                    "type": "Polygon",
                    "vertices": [[ax, ay], [bx, ay], [bx, by], [ax, by]],
                }
                n += 1

    # placeable obstacles (per-tile shapes with rotation + translation)
    for ob in env.obstacles:
        trow, tcol = ob.tile
        cx, cy = to_world(tcol, trow, ob.translation[0], ob.translation[1])
        shape = ob.shape
        if isinstance(shape, Circle):
            out[str(n)] = {
                "type": "Circle",
                "center": [cx, cy],
                "radius": shape.radius * tile,
            }
        else:
            if isinstance(shape, Rectangle):
                w, h = shape.width / 2.0, shape.height / 2.0
                pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]])
            elif isinstance(shape, RegularPolygon):
                # rendered at HALF the nominal radius (gbp_environment
                # lib.rs:298-301; collider scale tile_size/2,
                # map_generator.rs:349-366) — see env/model.py
                pts = shape.points() * 0.5
            elif isinstance(shape, Triangle):
                pts = shape.points()
            elif isinstance(shape, Polygon):
                pts = np.asarray(shape.points_list, dtype=float)
            else:  # pragma: no cover
                continue
            ang = ob.rotation
            ca, sa = math.cos(ang), math.sin(ang)
            rot = pts @ np.array([[ca, sa], [-sa, ca]])
            verts = [
                [cx + float(p[0]) * tile, cy - float(p[1]) * tile] for p in rot
            ]
            out[str(n)] = {"type": "Polygon", "vertices": verts}
        n += 1

    return out

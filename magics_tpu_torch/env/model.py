"""Declarative environment model (tile grid + per-tile obstacles).

Mirrors the reference's `gbp_environment` crate schema
(crates/gbp_environment/src/lib.rs): an ASCII tile grid where box-drawing
characters carve paths of `path_width` through tiles, plus parameterised
obstacle shapes placed at relative positions within tiles. Parsed from the
same `environment.yaml` files the reference ships.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import Any

import numpy as np


@dataclasses.dataclass
class Circle:
    radius: float  # relative to tile size, [0, 1]

    def expanded(self, e: float) -> "Circle":
        return Circle(self.radius + e)

    def inside(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return x * x + y * y <= self.radius**2


@dataclasses.dataclass
class Rectangle:
    width: float
    height: float

    def expanded(self, e: float) -> "Rectangle":
        return Rectangle(self.width + e * 2.0, self.height + e * 2.0)

    def inside(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        # reference quirk (gbp_environment lib.rs:349-358): "half" extents are
        # quarters, and width bounds y while height bounds x
        hw = self.width / 4.0
        hh = self.height / 4.0
        return (x >= -hh) & (x <= hh) & (y >= -hw) & (y <= hw)


@dataclasses.dataclass
class Triangle:
    angle_a: float  # radians
    angle_b: float
    radius: float  # inscribed-circle radius

    def expanded(self, e: float) -> "Triangle":
        return Triangle(self.angle_a, self.angle_b, self.radius + e)

    def points(self) -> np.ndarray:
        a, b = self.angle_a, self.angle_b
        c = math.pi - (a + b)
        ha = self.radius / math.sin(a)
        hb = self.radius / math.sin(b)
        hc = self.radius / math.sin(c)
        dirs = [math.pi + a / 2.0, -b / 2.0, math.pi - b - c / 2.0]
        hyp = [ha, hb, hc]
        return np.array([[math.cos(d) * h, math.sin(d) * h] for d, h in zip(dirs, hyp)])

    def inside(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        pts = self.points()
        return _point_in_convex(x, y, pts)


@dataclasses.dataclass
class RegularPolygon:
    sides: int
    radius: float

    def expanded(self, e: float) -> "RegularPolygon":
        return RegularPolygon(self.sides, self.radius + e * 2.0)

    def points(self) -> np.ndarray:
        # lib.rs:258-271 — vertices offset by pi/4
        pts = []
        for i in range(self.sides):
            ang = 2.0 * math.pi / self.sides * i + math.pi / 4.0
            pts.append([math.cos(ang) * self.radius, math.sin(ang) * self.radius])
        return np.array(pts)

    def inside(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        # reference quirk (gbp_environment lib.rs:298-301): the query point is
        # scaled by 2 before the ray cast, so the polygon renders at HALF its
        # nominal radius (the parry2d collider agrees: map_generator.rs:349-366
        # scales unit points by tile_size / 2). Missing this doubled obstacle
        # size and jammed the cluttered-circle scenarios (round-5 fix).
        return _point_in_polygon(x * 2.0, y * 2.0, self.points())


@dataclasses.dataclass
class Polygon:
    points_list: np.ndarray  # [N, 2] relative points

    def expanded(self, e: float) -> "Polygon":
        # lib.rs:385-404 — move every vertex away from the centroid by `e`
        pts = np.asarray(self.points_list, dtype=float)
        center = pts.mean(axis=0)
        d = pts - center
        norm = np.linalg.norm(d, axis=1, keepdims=True)
        unit = np.where(norm > 0, d / np.where(norm > 0, norm, 1.0), 0.0)
        return Polygon(pts + unit * e)

    def inside(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return _point_in_polygon(x, y, np.asarray(self.points_list, dtype=float))


def _point_in_convex(x, y, pts):
    def sign(px, py, ax, ay, bx, by):
        return (px - bx) * (ay - by) - (ax - bx) * (py - by)

    a, b, c = pts
    d1 = sign(x, y, a[0], a[1], b[0], b[1])
    d2 = sign(x, y, b[0], b[1], c[0], c[1])
    d3 = sign(x, y, c[0], c[1], a[0], a[1])
    has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(has_neg & has_pos)


def _point_in_polygon(x, y, poly):
    """Vectorised even-odd ray cast (lib.rs:422-438)."""
    inside = np.zeros_like(x, dtype=bool)
    n = len(poly)
    j = n - 1
    for i in range(n):
        ix, iy = poly[i]
        jx, jy = poly[j]
        cond = ((iy > y) != (jy > y)) & (
            x < (jx - ix) * (y - iy) / np.where(jy - iy != 0, jy - iy, 1e-30) + ix
        )
        inside ^= cond
        j = i
    return inside


SHAPE_KINDS = (Circle, Rectangle, Triangle, RegularPolygon, Polygon)


@functools.cache
def tagged_loader():
    """A SafeLoader that folds serde's `!variant`-style local tags into
    single-key dicts: `!circle {radius: 1}` -> {"circle": {radius: 1}}.
    PyYAML is imported here, when a YAML text is parsed, and not when the
    module is imported: a scenario built in memory needs no PyYAML."""
    import yaml

    class TaggedLoader(yaml.SafeLoader):
        pass

    def tagged(loader, tag_suffix: str, node):
        if isinstance(node, yaml.MappingNode):
            return {tag_suffix: loader.construct_mapping(node, deep=True)}
        if isinstance(node, yaml.SequenceNode):
            return {tag_suffix: loader.construct_sequence(node, deep=True)}
        return {tag_suffix: loader.construct_scalar(node)}

    TaggedLoader.add_multi_constructor("!", tagged)
    return TaggedLoader


def load_yaml(text: str):
    """Parse a scenario file: a JSON document with the stdlib's `json`, any
    other YAML text with `tagged_loader()`. JSON is YAML, and a JSON file
    writes a tagged node `!tag {...}` as the `{"tag": {...}}` the tagged
    loader folds it into, so both parsers give one tree (where its floats
    are written as PyYAML's YAML 1.1 reads them: `config.dump.json_yaml`).
    The card's machine has no PyYAML: there a scenario is written as JSON."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "this scenario file is not a JSON document, and parsing other YAML "
            "needs PyYAML, which is not installed") from e
    return yaml.load(text, Loader=tagged_loader())


@dataclasses.dataclass
class Obstacle:
    shape: Any
    rotation: float  # radians
    translation: tuple[float, float]  # relative within tile [0,1]^2
    tile: tuple[int, int]  # (row, col)


@dataclasses.dataclass
class SdfSettings:
    resolution: int = 200  # pixels per tile
    expansion: float = 0.1
    blur: float = 0.05


@dataclasses.dataclass
class Environment:
    grid: list[str]               # rows of tile characters
    tile_size: float
    path_width: float
    obstacle_height: float = 1.0
    sdf: SdfSettings = dataclasses.field(default_factory=SdfSettings)
    obstacles: list[Obstacle] = dataclasses.field(default_factory=list)

    @property
    def nrows(self) -> int:
        return len(self.grid)

    @property
    def ncols(self) -> int:
        return len(self.grid[0])

    @property
    def world_size(self) -> tuple[float, float]:
        """(width, height) in meters."""
        return (self.tile_size * self.ncols, self.tile_size * self.nrows)

    @classmethod
    def from_yaml(cls, text: str) -> "Environment":
        data = load_yaml(text)
        tiles = data["tiles"]
        settings = tiles["settings"]
        sdf_cfg = settings.get("sdf") or {}
        grid = [str(row) for row in tiles["grid"]]
        if not grid:
            raise ValueError("environment grid is empty")
        if len({len(r) for r in grid}) != 1:
            raise ValueError("environment grid rows have different lengths")
        obstacles = [_parse_obstacle(o) for o in (data.get("obstacles") or [])]
        return cls(
            grid=grid,
            tile_size=float(settings["tile-size"]),
            path_width=float(settings["path-width"]),
            obstacle_height=float(settings.get("obstacle-height", 1.0)),
            sdf=SdfSettings(
                resolution=int(sdf_cfg.get("resolution", 200)),
                expansion=float(sdf_cfg.get("expansion", 0.1)),
                blur=float(sdf_cfg.get("blur", 0.05)),
            ),
            obstacles=obstacles,
        )

    @classmethod
    def from_file(cls, path) -> "Environment":
        with open(path) as f:
            return cls.from_yaml(f.read())


def _parse_shape(node: Any) -> Any:
    """Parse the `!circle`-style YAML tagged shapes (serde adjacently-tagged
    enums load as {'circle': {...}} under safe_load with the reference's
    emitted YAML using local tags — handle both forms)."""
    if isinstance(node, dict) and len(node) == 1:
        (kind, body), = node.items()
    else:
        raise ValueError(f"unrecognised shape node: {node!r}")
    kind = kind.lstrip("!").replace("-", "_")
    if kind == "circle":
        return Circle(radius=float(body["radius"]))
    if kind == "rectangle":
        return Rectangle(width=float(body["width"]), height=float(body["height"]))
    if kind == "triangle":
        # angles are radians (the Angle type deserialises raw radians,
        # crates/angle/src/lib.rs:148-156)
        angles = body.get("angles", {})
        return Triangle(
            angle_a=float(angles.get("A", math.pi / 3)),
            angle_b=float(angles.get("B", math.pi / 3)),
            radius=float(body["radius"]),
        )
    if kind == "regular_polygon":
        return RegularPolygon(sides=int(body["sides"]), radius=float(body["radius"]))
    if kind == "polygon":
        pts = np.array([[float(p["x"]), float(p["y"])] for p in body["points"]])
        return Polygon(points_list=pts)
    raise ValueError(f"unknown shape kind: {kind}")


def _parse_obstacle(node: dict) -> Obstacle:
    tc = node.get("tile-coordinates", {})
    tr = node.get("translation", {}) or {}
    # Angle (de)serialises as plain radians in [0, 2pi] (angle/src/lib.rs:148-156)
    rot = float(node.get("rotation", 0.0))
    return Obstacle(
        shape=_parse_shape(node["shape"]),
        rotation=rot,
        translation=(float(tr.get("x", 0.5)), float(tr.get("y", 0.5))),
        tile=(int(tc.get("row", 0)), int(tc.get("col", 0))),
    )

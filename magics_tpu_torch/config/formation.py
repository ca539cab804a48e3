"""Formation YAML schema + robot placement.

Mirrors crates/gbp_config/src/formation.rs: formations spawn groups of robots
on shapes (line segments / circles) with equal or random non-overlapping
placement, project waypoints (identity or cross), and repeat on timers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from magics_tpu_torch.env.model import load_yaml  # shared tagged-YAML loader


@dataclasses.dataclass
class ReachedWhen:
    """formation.rs:162-208 — when a waypoint counts as reached."""

    distance: Optional[float]  # None = robot-radius, else meters
    intersects_with: Any       # "current" | "horizon" | ("variable", ix)

    @classmethod
    def parse(cls, node) -> "ReachedWhen":
        if node is None:
            return cls(None, "horizon")
        if isinstance(node, str):
            return cls(None, node)
        dist = node.get("distance", "robot-radius")
        if isinstance(dist, dict):  # {"meter": x}
            dist = float(dist.get("meter", 0.0))
        elif dist == "robot-radius":
            dist = None
        else:
            dist = float(dist) if not isinstance(dist, str) else None
        iw = node.get("intersects-with", "horizon")
        if isinstance(iw, dict):  # {"variable": ix}
            iw = ("variable", int(iw["variable"]))
        return cls(dist, iw)


@dataclasses.dataclass
class Shape:
    kind: str                       # "circle" | "line-segment"
    radius: float = 0.0             # circle (relative to world? no — meters? see note)
    center: tuple[float, float] = (0.5, 0.5)
    points: tuple = ()              # line segment endpoints (relative)


def _parse_shape(node) -> Shape:
    (kind, body), = node.items() if isinstance(node, dict) else [("?", None)]
    if kind == "circle":
        c = body.get("center", {})
        return Shape(
            kind="circle",
            radius=float(body["radius"]),
            center=(float(c.get("x", 0.5)), float(c.get("y", 0.5))),
        )
    if kind == "line-segment":
        pts = tuple((float(p["x"]), float(p["y"])) for p in body)
        return Shape(kind="line-segment", points=pts)
    raise ValueError(f"unsupported formation shape: {kind}")


@dataclasses.dataclass
class Waypoint:
    shape: Shape
    projection_strategy: str  # "identity" | "cross"


@dataclasses.dataclass
class Formation:
    robots: int
    planning_strategy: str  # "only-local" | "rrt-star"
    initial_shape: Shape
    placement: str          # "equal" | "random"
    placement_attempts: int
    waypoints: list[Waypoint]
    delay_s: float
    repeat_every_s: Optional[float]  # None = no repeat
    repeat_times: Optional[int]      # None = infinite
    waypoint_reached: ReachedWhen
    finished: ReachedWhen

    @classmethod
    def parse(cls, node: dict) -> "Formation":
        rep = node.get("repeat")
        repeat_every = None
        repeat_times: Optional[int] = None
        if rep:
            every = rep.get("every", {})
            repeat_every = float(every.get("secs", 0)) + float(every.get("nanos", 0)) * 1e-9
            times = rep.get("times")
            if isinstance(times, dict):
                if "finite" in times:
                    repeat_times = int(times["finite"])
                else:
                    repeat_times = None  # infinite
            elif times == "infinite" or times is None:
                repeat_times = None
            else:
                repeat_times = int(times)
        delay = node.get("delay", {})
        delay_s = float(delay.get("secs", 0)) + float(delay.get("nanos", 0)) * 1e-9
        ip = node["initial-position"]
        placement = ip.get("placement-strategy", "equal")
        attempts = 1000
        if isinstance(placement, dict):
            (placement, body), = placement.items()
            attempts = int(body.get("attempts", 1000)) if isinstance(body, dict) else 1000
        return cls(
            robots=int(node["robots"]),
            planning_strategy=str(node.get("planning-strategy", "only-local")),
            initial_shape=_parse_shape(ip["shape"]),
            placement=placement,
            placement_attempts=attempts,
            waypoints=[
                Waypoint(_parse_shape(w["shape"]), str(w.get("projection-strategy", "identity")))
                for w in node.get("waypoints", [])
            ],
            delay_s=delay_s,
            repeat_every_s=repeat_every,
            repeat_times=repeat_times,
            waypoint_reached=ReachedWhen.parse(node.get("waypoint-reached-when-intersects")),
            finished=ReachedWhen.parse(node.get("finished-when-intersects")),
        )

    # -- placement (formation.rs:304-475) -----------------------------------

    def as_positions(
        self, world_dims: tuple[float, float], radii: np.ndarray, rng: np.random.Generator
    ) -> Optional[tuple[np.ndarray, list[np.ndarray]]]:
        """Returns (initial_positions [N,2], [waypoint_positions [N,2] ...])."""
        ww, wh = world_dims

        def to_world(p):
            return np.array([(p[0] - 0.5) * ww, (p[1] - 0.5) * wh])

        if self.initial_shape.kind == "line-segment":
            ls = self.initial_shape.points
            a, b = to_world(ls[0]), to_world(ls[1])
            if self.placement == "equal":
                lerps = _evenly_place_on_segment(a, b, radii)
            else:
                lerps = _randomly_place_on_segment(a, b, radii, self.placement_attempts, rng)
            if lerps is None:
                return None
            initial = np.stack([a + (b - a) * t for t in lerps])
            wp_lists = []
            for wp in self.waypoints:
                wa, wb = to_world(wp.shape.points[0]), to_world(wp.shape.points[1])
                order = lerps[::-1] if wp.projection_strategy == "cross" else lerps
                wp_lists.append(np.stack([wa + (wb - wa) * t for t in order]))
            return initial, wp_lists

        if self.initial_shape.kind == "circle":
            r = self.initial_shape.radius
            center = to_world(self.initial_shape.center)
            if self.placement == "equal":
                angles = np.array(
                    [2.0 * math.pi * i / self.robots for i in range(self.robots)]
                )
            else:
                raise NotImplementedError(
                    "random circle placement is todo!() in the reference too "
                    "(formation.rs:408-421)"
                )
            initial = center + np.stack([np.cos(angles), np.sin(angles)], axis=1) * r
            wp_lists = []
            for wp in self.waypoints:
                if wp.projection_strategy != "cross":
                    raise ValueError("identity projection is invalid for circles")
                wc = to_world(wp.shape.center)
                a2 = angles + math.pi
                wp_lists.append(
                    wc + np.stack([np.cos(a2), np.sin(a2)], axis=1) * wp.shape.radius
                )
            return initial, wp_lists

        raise ValueError(self.initial_shape.kind)


def _evenly_place_on_segment(a, b, radii) -> Optional[np.ndarray]:
    # formation.rs:595-644 (including its quirky spacing arithmetic)
    radii = np.asarray(radii, dtype=np.float64)
    mn, mx = radii.min(), radii.max()
    length = float(np.linalg.norm(b - a))
    if length / mx < mn:
        return None
    extra = length / mx
    lerps = []
    center_dist = radii[0]
    rs = list(radii) + [0.0]
    for r1, r2 in zip(rs[:-1], rs[1:]):
        diff = r2 - r1
        lerps.append(center_dist / length)
        center_dist += (r1 + diff) * 2.0 + (extra - diff)
    return np.array(lerps)


def _randomly_place_on_segment(a, b, radii, max_attempts, rng) -> Optional[np.ndarray]:
    # formation.rs:551-592
    n = len(radii)
    for _ in range(max_attempts):
        placed: list[tuple[np.ndarray, float]] = []
        lerps: list[float] = []
        for radius in radii:
            t = float(rng.uniform(0.0, 1.0))
            pos = a + (b - a) * t
            ok = all(
                np.linalg.norm(pos - p) >= (orad + radius) for (p, orad) in placed
            )
            if ok:
                lerps.append(t)
                placed.append((pos, float(radius)))
                if len(placed) == n:
                    return np.array(lerps)
    return None


@dataclasses.dataclass
class FormationGroup:
    formations: list[Formation]

    @classmethod
    def from_yaml(cls, text: str) -> "FormationGroup":
        data = load_yaml(text)
        return cls(formations=[Formation.parse(f) for f in data.get("formations", [])])

    @classmethod
    def from_file(cls, path) -> "FormationGroup":
        with open(path) as f:
            return cls.from_yaml(f.read())

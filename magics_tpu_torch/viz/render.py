"""Headless scene rendering (counterpart of magics_tpu's viz/render.py).

The reference renders the simulation live in Bevy with 11 visualiser plugins
(crates/magics/src/planner/visualiser/mod.rs:33-49: predicted trajectories,
communication graph, comms radii, uncertainty ellipses, waypoints, tracers,
obstacle-factor measurements, inter-robot factor lines, colliders, tracking
projections, robot meshes) themed with Catppuccin (crates/magics/src/
theme.rs). Headless equivalents here:

  * `render_frame`  — one PNG frame of the world at a sample index: obstacle
    raster, robot discs (per-robot catppuccin accent colors like the
    reference's ColorAssociation), travelled tracers, waypoints, comms links.
  * `record_frames` — frame sequence from an export dict (the `--record`
    image-sequence exporter, crates/magics/src/main.rs:460-565).
  * `render_trajectories` — one static overview figure of all trajectories.

All drawing is done straight into a numpy RGB buffer (no display server
required), over an export dict (`Simulator.export()`), pixel for pixel as the
JAX package draws it; `viz/png.py` encodes the PNGs (no Pillow).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from magics_tpu_torch.viz.png import write_png

# Catppuccin Macchiato (the reference's default theme, theme.rs) — base/text
# plus the accent cycle used for per-robot colors.
BASE = (36, 39, 58)
SURFACE = (54, 58, 79)
TEXT = (202, 211, 245)
OVERLAY = (110, 115, 141)
ACCENTS = [
    (244, 219, 214),  # rosewater
    (240, 198, 198),  # flamingo
    (245, 189, 230),  # pink
    (198, 160, 246),  # mauve
    (237, 135, 150),  # red
    (238, 153, 160),  # maroon
    (245, 169, 127),  # peach
    (238, 212, 159),  # yellow
    (166, 218, 149),  # green
    (139, 213, 202),  # teal
    (145, 215, 227),  # sky
    (125, 196, 231),  # sapphire
    (138, 173, 244),  # blue
    (183, 189, 248),  # lavender
]


def robot_color(i: int) -> tuple[int, int, int]:
    """Per-robot accent color (theme.rs ColorAssociation analogue)."""
    return ACCENTS[i % len(ACCENTS)]


class Canvas:
    """A world-coordinate RGB raster. y-up world maps to row-0-at-top image
    (the same mapping as the SDF / collision pixel transforms)."""

    def __init__(self, world: tuple[float, float], px_per_m: float = 6.0,
                 background: np.ndarray | None = None):
        self.world = world
        self.W = int(round(world[0] * px_per_m))
        self.H = int(round(world[1] * px_per_m))
        self.sx = self.W / world[0]
        self.sy = self.H / world[1]
        self.img = np.empty((self.H, self.W, 3), dtype=np.uint8)
        self.img[:] = BASE
        if background is not None:
            self.blit_obstacles(background)

    def blit_obstacles(self, obstacle: np.ndarray) -> None:
        """obstacle: [h, w] bool raster (True = obstacle)."""
        ys = (np.arange(self.H) * obstacle.shape[0] / self.H).astype(int)
        xs = (np.arange(self.W) * obstacle.shape[1] / self.W).astype(int)
        mask = obstacle[np.ix_(ys, xs)]
        self.img[mask] = SURFACE

    def to_px(self, x: float, y: float) -> tuple[int, int]:
        return (
            int((x + self.world[0] / 2.0) * self.sx),
            int((-y + self.world[1] / 2.0) * self.sy),
        )

    def disc(self, x: float, y: float, r_m: float, color, alpha: float = 1.0):
        cx, cy = self.to_px(x, y)
        r = max(1, int(r_m * self.sx))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, self.H)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, self.W)
        if y0 >= y1 or x0 >= x1:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        patch = self.img[y0:y1, x0:x1]
        c = np.array(color, dtype=np.float32)
        patch[m] = (patch[m] * (1 - alpha) + c * alpha).astype(np.uint8)

    def circle(self, x: float, y: float, r_m: float, color):
        cx, cy = self.to_px(x, y)
        r = max(1, int(r_m * self.sx))
        n = max(12, int(2 * math.pi * r / 3))
        for k in range(n):
            a = 2 * math.pi * k / n
            px, py = int(cx + r * math.cos(a)), int(cy + r * math.sin(a))
            if 0 <= px < self.W and 0 <= py < self.H:
                self.img[py, px] = color

    def line(self, x0, y0, x1, y1, color, alpha: float = 1.0):
        p0, p1 = self.to_px(x0, y0), self.to_px(x1, y1)
        n = max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)
        xs = np.linspace(p0[0], p1[0], n + 1).astype(int)
        ys = np.linspace(p0[1], p1[1], n + 1).astype(int)
        ok = (xs >= 0) & (xs < self.W) & (ys >= 0) & (ys < self.H)
        c = np.array(color, dtype=np.float32)
        self.img[ys[ok], xs[ok]] = (
            self.img[ys[ok], xs[ok]] * (1 - alpha) + c * alpha
        ).astype(np.uint8)

    def cross(self, x, y, size_m, color):
        s = size_m
        self.line(x - s, y, x + s, y, color)
        self.line(x, y - s, x, y + s, color)

    def save(self, path) -> None:
        write_png(path, self.img)


# --------------------------------------------------------------------------


def _positions_at(robots: dict, k: int) -> dict[str, tuple[float, float]]:
    out = {}
    for rid, r in robots.items():
        pos = r["positions"]
        if pos and k < len(pos):
            out[rid] = tuple(pos[k][:2])
    return out


def render_frame(
    export: dict,
    k: int,
    *,
    obstacle: np.ndarray | None = None,
    world: tuple[float, float],
    px_per_m: float = 6.0,
    comms_radius: float | None = None,
    tracer: int = 40,
) -> np.ndarray:
    """Render sample index `k` of an export dict. Returns [H, W, 3] u8."""
    cv = Canvas(world, px_per_m, background=obstacle)
    robots = export["robots"]

    # waypoint visualiser
    for i, (rid, r) in enumerate(robots.items()):
        col = robot_color(i)
        wps = r["mission"]["waypoints"]
        for a, b in zip(wps, wps[1:]):
            cv.line(a[0], a[1], b[0], b[1], OVERLAY, alpha=0.35)
        if wps:
            cv.cross(wps[-1][0], wps[-1][1], 1.0, col)

    # tracers (travelled path)
    for i, (rid, r) in enumerate(robots.items()):
        col = robot_color(i)
        pos = r["positions"][max(0, k - tracer) : k + 1]
        for a, b in zip(pos, pos[1:]):
            cv.line(a[0], a[1], b[0], b[1], col, alpha=0.5)

    # communication graph
    now = _positions_at(robots, k)
    if comms_radius is not None:
        ids = list(now)
        for a_i in range(len(ids)):
            for b_i in range(a_i + 1, len(ids)):
                pa, pb = now[ids[a_i]], now[ids[b_i]]
                if (pa[0] - pb[0]) ** 2 + (pa[1] - pb[1]) ** 2 <= comms_radius**2:
                    cv.line(pa[0], pa[1], pb[0], pb[1], OVERLAY, alpha=0.4)

    # robot discs
    for i, (rid, r) in enumerate(robots.items()):
        if rid in now:
            x, y = now[rid]
            cv.disc(x, y, r.get("radius", 1.0), robot_color(i))

    return cv.img


def record_frames(
    export: dict,
    out_dir: str | Path,
    *,
    obstacle: np.ndarray | None = None,
    world: tuple[float, float],
    px_per_m: float = 6.0,
    comms_radius: float | None = None,
    every: int = 1,
) -> int:
    """Write frame_%05d.png for every `every`-th position sample (the
    `--record` image-sequence exporter, main.rs:460-565). Returns frame
    count. Convert with e.g. ffmpeg -i frame_%05d.png out.mp4."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = max((len(r["positions"]) for r in export["robots"].values()), default=0)
    count = 0
    for k in range(0, n, every):
        img = render_frame(
            export, k, obstacle=obstacle, world=world, px_per_m=px_per_m,
            comms_radius=comms_radius,
        )
        write_png(out / f"frame_{count:05d}.png", img)
        count += 1
    return count


def render_trajectories(
    export: dict,
    path: str | Path | None = None,
    *,
    obstacle: np.ndarray | None = None,
    world: tuple[float, float],
    px_per_m: float = 6.0,
) -> np.ndarray:
    """One overview image: full trajectory of every robot + waypoints."""
    cv = Canvas(world, px_per_m, background=obstacle)
    robots = export["robots"]
    for i, (rid, r) in enumerate(robots.items()):
        col = robot_color(i)
        wps = r["mission"]["waypoints"]
        for a, b in zip(wps, wps[1:]):
            cv.line(a[0], a[1], b[0], b[1], OVERLAY, alpha=0.3)
        pos = r["positions"]
        for a, b in zip(pos, pos[1:]):
            cv.line(a[0], a[1], b[0], b[1], col, alpha=0.8)
        if pos:
            cv.disc(pos[-1][0], pos[-1][1], r.get("radius", 1.0), col)
    if path is not None:
        cv.save(path)
    return cv.img


def main(argv=None) -> int:
    """python -m magics_tpu_torch.viz.render <export.json> [--out DIR|PNG] ..."""
    import argparse

    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.env.sdf import env_to_image

    p = argparse.ArgumentParser(description="render an experiment export")
    p.add_argument("export", help="export JSON path")
    p.add_argument("--scenario-dir", help="scenario dir for the environment raster")
    p.add_argument("--out", default="trajectories.png")
    p.add_argument("--frames", action="store_true", help="write a frame sequence")
    p.add_argument("--px-per-m", type=float, default=6.0)
    p.add_argument("--every", type=int, default=1)
    args = p.parse_args(argv)

    export = json.loads(Path(args.export).read_text())
    obstacle = None
    world = (100.0, 100.0)
    comms = None
    if args.scenario_dir:
        sc = load_scenario(args.scenario_dir)
        world = sc.environment.world_size
        obstacle = env_to_image(sc.environment, expansion=0.0) == 0
        comms = sc.config.robot.communication.radius
    elif "config" in export:
        try:
            world_cfg = export["config"]
            comms = world_cfg["robot"]["communication"]["radius"]
        except (KeyError, TypeError):
            pass

    if args.frames:
        n = record_frames(
            export, args.out, obstacle=obstacle, world=world,
            px_per_m=args.px_per_m, comms_radius=comms, every=args.every,
        )
        print(f"wrote {n} frames to {args.out}")
    else:
        render_trajectories(
            export, args.out, obstacle=obstacle, world=world, px_per_m=args.px_per_m
        )
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Offline experiment metrics (the reference's scripts/ directory).

Consumes the JSON export schema. Metrics:

  * LDJ — log dimensionless jerk per robot (scripts/ldj.py:17-55)
  * distance travelled per robot (scripts/distance-travelled.py:30-37)
  * makespan (virtual seconds to scenario completion)
  * perpendicular path deviation per robot
    (scripts/perpendicular-path-deviation.py)

CLI:  python -m magics_tpu_torch.analysis <export.json> [--metric all|ldj|...]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np


def ldj(velocities: np.ndarray, timestamps: np.ndarray) -> float:
    """Log dimensionless jerk (scripts/ldj.py:17-55, trapezoid integration in
    place of scipy's simpson so the framework stays dependency-light)."""
    assert len(velocities) > 0 and velocities.shape == (len(velocities), 2)
    t_start, t_final = timestamps[0], timestamps[-1]
    dt = float(np.mean(np.diff(timestamps)))
    ax = np.gradient(velocities[:, 0], dt)
    ay = np.gradient(velocities[:, 1], dt)
    jx = np.gradient(ax, dt)
    jy = np.gradient(ay, dt)
    squared_jerk = jx**2 + jy**2
    samples = np.linspace(t_start, t_final, len(velocities))
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz
    integral = trapezoid(squared_jerk, x=samples)
    v_max = float(np.max(np.linalg.norm(velocities, axis=1)))
    return float(-np.log((t_final - t_start) ** 3 / v_max**2 * integral))


def distance_travelled(positions: np.ndarray) -> float:
    """Polyline length (scripts/distance-travelled.py:30-37)."""
    return float(np.sum(np.linalg.norm(np.diff(positions, axis=0), axis=1)))


def perpendicular_path_deviation(positions: np.ndarray, waypoints: np.ndarray) -> float:
    """Mean distance from each position sample to the mission polyline
    (scripts/perpendicular-path-deviation.py)."""
    if len(waypoints) < 2 or len(positions) == 0:
        return 0.0
    best = np.full(len(positions), np.inf)
    for a, b in zip(waypoints, waypoints[1:]):
        ab = b - a
        denom = float(ab @ ab)
        if denom == 0.0:
            d = np.linalg.norm(positions - a, axis=1)
        else:
            t = np.clip((positions - a) @ ab / denom, 0.0, 1.0)
            proj = a + t[:, None] * ab
            d = np.linalg.norm(positions - proj, axis=1)
        best = np.minimum(best, d)
    return float(np.mean(best))


def _robot_series(robot: dict):
    pos = np.asarray(robot["positions"], dtype=float)
    ts = np.array([m["timestamp"] for m in robot["velocities"]], dtype=float)
    vel3 = np.array([m["velocity"] for m in robot["velocities"]], dtype=float)
    vel = vel3[:, [0, 2]] if vel3.ndim == 2 and vel3.shape[1] == 3 else vel3
    wps = np.asarray(robot["mission"]["waypoints"], dtype=float)[:, :2]
    return pos, vel, ts, wps


def analyse(export: dict) -> dict:
    per_robot: dict[str, dict] = {}
    for rid, robot in export["robots"].items():
        pos, vel, ts, wps = _robot_series(robot)
        entry: dict = {}
        if len(pos) >= 2:
            entry["distance_travelled"] = distance_travelled(pos)
            entry["path_deviation"] = perpendicular_path_deviation(pos, wps)
        if len(vel) >= 3 and len(ts) == len(vel) and np.all(np.diff(ts) > 0):
            entry["ldj"] = ldj(vel, ts)
        mission = robot["mission"]
        entry["duration"] = mission.get("duration")
        per_robot[rid] = entry

    def stats(key):
        vals = [e[key] for e in per_robot.values() if e.get(key) is not None]
        if not vals:
            return None
        return {
            "mean": statistics.mean(vals),
            "median": statistics.median(vals),
            "min": min(vals),
            "max": max(vals),
            "stdev": statistics.stdev(vals) if len(vals) > 1 else 0.0,
            "n": len(vals),
        }

    return {
        "makespan": export.get("makespan"),
        "robots": len(per_robot),
        "ldj": stats("ldj"),
        "distance_travelled": stats("distance_travelled"),
        "path_deviation": stats("path_deviation"),
        "per_robot": per_robot,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("export", type=Path)
    p.add_argument("--per-robot", action="store_true")
    args = p.parse_args(argv)
    result = analyse(json.loads(args.export.read_text()))
    if not args.per_robot:
        result.pop("per_robot")
    json.dump(result, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())

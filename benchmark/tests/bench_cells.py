"""The benchmark's cells cut to sizes a CPU test run can hold."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402

# 3 robots on a 15 m circle, so that a row's robots finish within 100
# ticks on the CPU; short live episodes; the sweep follows 8 ticks
SMALL = {
    "circle-experiment.live": {
        "config": {"formation": {"robots": 3, "circle_radius": 15.0}},
        "traffic": {"episode_ticks": 15}},
    "circle-experiment.sweep": {
        "config": {"formation": {"circle_radius": 15.0},
                   "toml": {"simulation": {"max-time": 12.0}}},
        "traffic": {"rows": [3], "warm_rows": [3]}, "data": {"follow_ticks": 8}},
}


def merge(a: dict, b: dict) -> dict:
    """`a` with `b`'s entries, nested groups key by key."""
    return {**a, **{k: merge(a[k], v) if isinstance(v, dict) and isinstance(a.get(k), dict)
                    else v for k, v in b.items()}}


def small_cell(name: str, sizes: dict | None = None):
    """The cell with its configuration, traffic and data cut by `sizes`."""
    cell = H.cell(name)
    for part, cut in (sizes or {}).items():
        setattr(cell, part, merge(getattr(cell, part), cut))
    return cell

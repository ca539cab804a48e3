"""Experiment sweep runner — the reference's fish harness as one module
(counterpart of scripts/run_experiment.py).

Mirrors scripts/run-circle-expertiment.fish (seeds 0/31/227/252/805, robot
counts 5..50 step 5) and its siblings: for every (seed, robot-count) cell it
runs the scenario headless to completion, writes the JSON export, and folds
the offline metrics (makespan, LDJ, distance travelled, path deviation —
magics_tpu_torch/analysis.py) into one summary JSON for plotting.

    python -m magics_tpu_torch.scripts.run_experiment "Circle Experiment" \
        --scenarios-dir config/scenarios \
        --seeds 0,31,227,252,805 --robots 5:50:5 --out results/

The flags, their defaults and parsing, the sweep's loop order, the tags, the
export file names and the rows are the JAX script's, but for two flags:
`--platform cuda|cpu` (the card by default; without one it raises) and
`--scenarios-dir`, which defaults to ./config/scenarios. Each row is a fresh
`Simulator`: on the card its run captures its own chunk graph, which the
row's line on stderr times beside the replays, the export and the analysis.
A row holds the JAX row's keys and no other.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

# the sweep's axes in the JAX script's loop order, outermost first (the
# seeds innermost): each row key and the config field it overrides (the
# robot count is the first formation's)
AXES = (
    ("robots", None),
    ("target_speed", "robot.target_speed"),
    ("schedule", "gbp.iteration_schedule.schedule"),
    ("internal", "gbp.iteration_schedule.internal"),
    ("external", "gbp.iteration_schedule.external"),
    ("comms_radius", "robot.communication.radius"),
    ("tracking", "gbp.factors_enabled.tracking"),
    ("sigma_tracking", "gbp.sigma_factor_tracking"),
    ("failure_rate", "robot.communication.failure_rate"),
)
# the order the optional keys follow `metrics` in a row
ROW_KEYS = ("failure_rate", "target_speed", "schedule", "internal", "external",
            "comms_radius", "tracking", "sigma_tracking")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scenario")
    p.add_argument("--scenarios-dir", default="./config/scenarios")
    p.add_argument("--seeds", default="0,31,227,252,805")
    p.add_argument("--robots", default=None,
                   help="start:stop:step sweep of the first formation's robot "
                        "count (e.g. 5:50:5); default: scenario as-is")
    p.add_argument("--max-time", type=float, default=None)
    p.add_argument("--failure-rates", default=None,
                   help="comma list sweeping robot.communication.failure-rate "
                        "(the reference's comms-failure harness sweeps "
                        "0.0..0.7, run-communication-failure-expertiment.fish)")
    p.add_argument("--target-speeds", default=None,
                   help="comma list sweeping robot.target-speed (the "
                        "reference's comms-failure harness sweeps v0 10,15)")
    p.add_argument("--schedules", default=None,
                   help="comma list sweeping gbp.iteration-schedule.schedule "
                        "(run-schedules-experiment.fish sweeps all five kinds)")
    p.add_argument("--internals", default=None,
                   help="comma list sweeping gbp.iteration-schedule.internal "
                        "(run-iteration-amount-experiment.fish: fibonacci)")
    p.add_argument("--externals", default=None,
                   help="comma list sweeping gbp.iteration-schedule.external")
    p.add_argument("--comms-radii", default=None,
                   help="comma list sweeping robot.communication.radius "
                        "(run-varying-network-connectivity: 20,40,60,80)")
    p.add_argument("--tracking", default=None,
                   help="comma list of true/false sweeping "
                        "gbp.factors-enabled.tracking (solo/collab GP)")
    p.add_argument("--sigma-trackings", default=None,
                   help="comma list sweeping gbp.sigma-factor-tracking")
    p.add_argument("--preplan", action="store_true",
                   help="pre-plan rrt-star routes at build time instead of "
                        "in-flight (Simulator(inflight_planning=False)): "
                        "in-flight plan application depends on host "
                        "wall-clock vs the poll cadence, so same-seed sweep "
                        "rows are only reproducible with this flag")
    p.add_argument("--out", default="experiment-out")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="where the rows run: the card (the default; without "
                        "one it raises) or the CPU")
    return p


def _values(text: str | None, cast) -> list:
    return [cast(x) for x in text.split(",")] if text else [None]


def sweep(args: argparse.Namespace) -> list[dict]:
    """Every cell of the sweep, in the JAX script's loop order (seeds
    innermost): a dict of each axis' value (None where it is not swept)
    and the seed."""
    if args.robots:
        a, b, c = (int(x) for x in args.robots.split(":"))
        robots = list(range(a, b + 1, c))
    else:
        robots = [None]
    axes = {
        "robots": robots,
        "target_speed": _values(args.target_speeds, float),
        "schedule": args.schedules.split(",") if args.schedules else [None],
        "internal": _values(args.internals, int),
        "external": _values(args.externals, int),
        "comms_radius": _values(args.comms_radii, float),
        "tracking": _values(args.tracking, lambda x: x.strip().lower() == "true"),
        "sigma_tracking": _values(args.sigma_trackings, float),
        "failure_rate": _values(args.failure_rates, float),
    }
    seeds = [int(s) for s in args.seeds.split(",")]
    keys = [key for key, _ in AXES]
    return [dict(zip(keys + ["seed"], values))
            for values in itertools.product(*(axes[k] for k in keys), seeds)]


def scenario_for(base, cell: dict):
    """A copy of `base` with the cell's overrides applied."""
    from magics_tpu_torch.core.schedule import ScheduleKind

    sc = copy.deepcopy(base)
    for key, field in AXES:
        value = cell[key]
        if value is None:
            continue
        if key == "robots":
            sc.formations.formations[0].robots = value
            continue
        if key == "schedule":
            value = ScheduleKind(value)
        *path, last = field.split(".")
        obj = sc.config
        for name in path:
            obj = getattr(obj, name)
        setattr(obj, last, value)
    return sc


def tag(scenario: str, cell: dict) -> str:
    """The JAX script's tag of a cell (its export file is export_{tag}.json)."""
    n, v0, sk, it, ex = (cell[k] for k in ("robots", "target_speed", "schedule", "internal",
                                           "external"))
    cr, tk, stk, fr = (cell[k] for k in ("comms_radius", "tracking", "sigma_tracking",
                                         "failure_rate"))
    return f"{scenario.replace(' ', '-')}_r{n or 'cfg'}" + (
        f"_v{v0:g}" if v0 is not None else ""
    ) + (
        f"_k{sk}" if sk is not None else ""
    ) + (
        f"_i{it}" if it is not None else ""
    ) + (
        f"_e{ex}" if ex is not None else ""
    ) + (
        f"_c{cr:g}" if cr is not None else ""
    ) + (
        f"_t{int(tk)}" if tk is not None else ""
    ) + (
        f"_g{stk:g}" if stk is not None else ""
    ) + (
        f"_f{fr}" if fr is not None else ""
    ) + f"_s{cell['seed']}"


class Row(NamedTuple):
    row: dict           # the summary row, the JAX script's keys
    sim: object         # the Simulator that ran it (its stats, graphs, state)
    times: dict         # seconds / ms of the row's parts (not in the row)


def run_row(base, scenario: str, cell: dict, *, out_dir: Path, max_time=None,
            preplan: bool = False, device="cuda") -> Row:
    """One row: a fresh Simulator of the cell's scenario, run, exported to
    out_dir/export_{tag}.json and analysed."""
    from magics_tpu_torch.analysis import analyse
    from magics_tpu_torch.sim.simulator import Simulator

    sc = scenario_for(base, cell)
    t0 = time.perf_counter()
    sim = Simulator(sc, seed=cell["seed"], max_sim_time=max_time, viz_log=False,
                    inflight_planning=not preplan, device=device)
    t1 = time.perf_counter()
    result = sim.run()
    t2 = time.perf_counter()
    export = sim.export(out_dir / f"export_{tag(scenario, cell)}.json")
    t3 = time.perf_counter()
    metrics = analyse(export)
    t4 = time.perf_counter()
    metrics.pop("per_robot", None)
    row = {
        "robots": cell["robots"] or len(sim.specs),
        "seed": cell["seed"],
        "wall_s": round(t4 - t0, 2),
        **result,
        "metrics": metrics,
    }
    for key in ROW_KEYS:
        if cell[key] is not None:
            row[key] = cell[key]
    capture_s = sum(s for _, s in sim.stats.captures)
    times = {"build_s": t1 - t0, "run_s": t2 - t1, "capture_s": capture_s,
             "replay_s": t2 - t1 - capture_s, "export_ms": 1e3 * (t3 - t2),
             "analysis_ms": 1e3 * (t4 - t3)}
    return Row(row, sim, times)


def main(argv=None, on_row=None) -> int:
    """The sweep. `on_row(Row)` sees each row's Simulator and times after
    the row ran (the JAX script has no such hook)."""
    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.graph.state import require_device

    args = _parser().parse_args(argv)
    device = require_device(args.platform)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    base = load_scenario(Path(args.scenarios_dir) / args.scenario)

    summary: list[dict] = []
    for cell in sweep(args):
        done = run_row(base, args.scenario, cell, out_dir=out_dir, max_time=args.max_time,
                       preplan=args.preplan, device=device)
        t = done.times
        print(f"{tag(args.scenario, cell)} on {device}: build {t['build_s']:.2f} s, run "
              f"{t['run_s']:.2f} s (capture {t['capture_s']:.2f} s, the rest "
              f"{t['replay_s']:.2f} s), export {t['export_ms']:.1f} ms, analysis "
              f"{t['analysis_ms']:.1f} ms", file=sys.stderr)
        if on_row is not None:
            on_row(done)
        summary.append(done.row)
        print(json.dumps(done.row))

    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(f"wrote {out_dir / 'summary.json'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The experiment sweep: `run_experiment.run_row` over the traffic's robot
counts in turn, each row a fresh Simulator (build, capture, a run to
completion, the export), as an experiment user's sweep runs them.

Window: rows start while the window is open; the last one runs to its end.
`row_s` is the rows' wall seconds over their number. Each row's export goes
to a directory under TMPDIR that is deleted after the row.

Check: for a sample of the rows drawn from the seed, the one with the most
robots among them, the reference runs `follow_ticks` ticks at the start of
each of the row's first two chunks: from its own start, built from the
configuration, and from the program's state at the end of the first chunk
(kept by the benchmark as the Simulator hands it on). The program's logged
positions of those ticks (what the export holds) are held to the
reference's. Every row is held to the experiment's own contract and to its
configuration: every robot finishes within the max time, no neighbour is
dropped (a row has a slot for every other robot), and each robot's final
position lies within its finishing distance (its radius) and one tick's
travel at the target speed of its goal, the point opposite its start, which
the reference works out from the configuration (a robot's finish is tested
once a tick, on its estimate). The central crossing is not compared: two float32 paths part
by metres within 20 ticks of GBP, and the program hands on its state only
between chunks.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

from benchmark import deploy
from benchmark.harness import Check, Outcome, device_trace, log


def _logged(logs, spans: list, dt: float) -> dict:
    """{(robot, sample time in ticks): (x, y)} of the samples in `spans`,
    [(first tick, ticks)]."""
    out = {}
    for i, rl in enumerate(logs):
        for t, x, y in rl.positions:
            k = round(t / dt)
            if any(a <= k < a + n for a, n in spans):
                out[(i, k)] = (x, y)
    return out


def _reference_log(ctx, robots: int, ticks: int, start=None, tf32: bool = False) -> dict:
    """The reference's logged positions over `ticks` ticks from the row's
    start (its own, built from the configuration) or from `start`, a state
    the program handed on: {(robot, sample time in ticks): (x, y)}."""
    import math

    import torch

    from benchmark.reference import compare, scenarios

    params, own, sdf, env_dist = scenarios.circle_experiment(
        ctx.cell.config, robots, ctx.seed, viz_log=False, dtype=torch.float32,
        device=ctx.device)
    first = 0 if start is None else int(start.tick)
    st = compare.follow(params, own if start is None else start, sdf, env_dist, ticks,
                        tf32=tf32)
    every = params.log_every
    log_ = st.pos_log.double().cpu().numpy()   # [L, R, 2]
    want = {}
    for m in range(min(int(st.log_head), log_.shape[0])):
        for i in range(robots):
            x, y = log_[m, i]
            if not math.isnan(x) and first <= m * every < first + ticks:
                want[(i, m * every)] = (x, y)
    return want


def _gap(got: dict, want: dict) -> float:
    """The widest distance between two logs' positions; infinite where
    they hold different samples."""
    import math

    if set(got) != set(want):
        return math.inf
    per_tick: dict = {}
    for (i, k), (x, y) in want.items():
        d = math.hypot(x - got[(i, k)][0], y - got[(i, k)][1])
        per_tick[k] = max(per_tick.get(k, 0.0), d)
    log("[sweep] widest gap by tick: " + " ".join(f"{k}:{v:.3g}" for k, v in sorted(per_tick.items())))
    return max(per_tick.values(), default=0.0)


def run(ctx) -> Outcome:
    import torch  # noqa: F401  (the card's runtime starts here)

    from magics_tpu_torch.graph.chunk import TickGraph, clone_state
    from magics_tpu_torch.scripts import run_experiment as X
    from magics_tpu_torch.sim import simulator as S

    cfg, traffic, data = ctx.cell.config, ctx.cell.traffic, ctx.cell.data
    rows, follow_ticks = traffic["rows"], data["follow_ticks"]
    base = deploy.circle_scenario(cfg, ctx.seed)
    seeds = ctx.rng("rows").integers(0, 2**31 - 1, size=10_000)
    tmp_root = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())

    # the state the Simulator hands from its first chunk to its second,
    # kept for the check (a clone a row)
    handed: dict = {}
    real_chunk = S.Simulator._chunk

    def chunk(self, state, n, sizes):
        out = real_chunk(self, state, n, sizes)
        if handed.get("sim") is not self:
            handed.clear()
            handed.update(sim=self, state=clone_state(out))
        return out

    ctx.patch(S.Simulator, "_chunk", chunk)

    def row(k: int):
        robots = rows[k % len(rows)]
        cell = {key: None for key, _ in X.AXES} | {"robots": robots, "seed": int(seeds[k])}
        out_dir = Path(tempfile.mkdtemp(prefix="magics-bench-row-", dir=tmp_root))
        try:
            t0 = time.perf_counter()
            done = X.run_row(base, "Circle Experiment", cell, out_dir=out_dir,
                             device=ctx.device)
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        mid = handed.pop("state")
        handed.clear()
        spans = [(0, follow_ticks)]
        if done.row["ticks"] >= int(mid.tick) + follow_ticks:
            spans.append((int(mid.tick), follow_ticks))
        else:
            mid = None
        return {
            "robots": robots, "wall_s": wall, "capture_s": done.times["capture_s"],
            "replay_s": done.times["replay_s"], "completed": done.row["completed"],
            "ticks": done.row["ticks"], "mid": mid,
            "dropped": done.row["nbr_overflow"] + done.row["grid_overflow"],
            "final_pos": done.sim.state.pos.double().cpu().numpy(),
            "logged": _logged(done.sim.logs, spans, 1.0 / done.sim.hz),
        }

    for robots in traffic["warm_rows"]:
        warm = row(rows.index(robots))
        log(f"[sweep] warm row R={robots}: {warm['wall_s']:.3f} s "
            f"(capture {warm['capture_s']:.3f} s)")

    if ctx.trace:
        sync = ctx.sync
        ctx.wrap(S.Simulator, "__init__", "row.build")
        ctx.wrap(S, "compile_ticks", "row.capture", before=sync)
        ctx.wrap(TickGraph, "replay", "row.replay")
        ctx.wrap(S.Simulator, "export", "row.export", before=sync)
    traces = []
    done = []
    t_end = ctx.open_window()
    t0 = time.perf_counter()
    k = 0
    while True:
        if ctx.trace and k == traffic["trace_row"]:
            with device_trace(traces, ctx.spans):
                done.append(row(k))
        else:
            done.append(row(k))
        k += 1
        if time.perf_counter() >= t_end and (not ctx.trace or k > traffic["trace_row"]):
            break
    window_s = time.perf_counter() - t0
    ctx.close_window()
    ctx.restore()

    walls = [r["wall_s"] for r in done]
    for r in done:
        log(f"[sweep] row R={r['robots']}: {r['wall_s']:.3f} s, capture {r['capture_s']:.3f} s, "
            f"replay {r['replay_s']:.3f} s, {r['completed']}/{r['robots']} done by tick "
            f"{r['ticks']}")
    log(f"[sweep] {len(done)} rows in {window_s:.3f} s")
    unfinished = max(r["robots"] - r["completed"] for r in done)
    out = Outcome(
        attempted=len(done), failed=sum(r["completed"] < r["robots"] for r in done),
        end_to_end={"row_s": sum(walls) / len(walls)},
        traces={"window": traces[0]} if traces else {},
        stats={"rows": done},
    )

    out.notes.extend({"row": i, "robots": r["robots"], "wall_s": r["wall_s"],
                      "capture_s": r["capture_s"], "replay_s": r["replay_s"]}
                     for i, r in enumerate(done))

    # the check: a sample of rows drawn from the seed, with the largest
    pick = ctx.rng("check").permutation(len(done))[: data["check_rows"]].tolist()
    largest = max(range(len(done)), key=lambda i: (done[i]["robots"], i))
    if largest not in pick:
        pick[-1] = largest
    gap = control_gap = 0.0
    for i in pick:
        r = done[i]
        starts = [None] + ([r["mid"]] if r["mid"] is not None else [])
        want = {}
        for start in starts:
            want |= _reference_log(ctx, r["robots"], follow_ticks, start=start)
        gap = max(gap, _gap(r["logged"], want))
        if ctx.control:
            control = {}
            for start in starts:
                control |= _reference_log(ctx, r["robots"], follow_ticks, start=start, tf32=True)
            control_gap = max(control_gap, _gap(control, want))
    log(f"[sweep] checked rows {sorted(pick)}: {follow_ticks} ticks from the start of each "
        f"of their first two chunks")

    # every row's end: each robot's final position against its goal
    import numpy as np

    from benchmark.reference.scenarios import circle_goals

    goal_miss = max(float(np.hypot(*(r["final_pos"] - circle_goals(cfg, r["robots"], ctx.seed)).T)
                          .max()) for r in done)
    robot = cfg["toml"]["robot"]
    finish_m = robot["radius"]["max"] + robot["target-speed"] / cfg["toml"]["simulation"]["hz"]
    limits = data["limits"]
    out.checks = [Check("pos_gap_m", gap, limits["pos_gap_m"]),
                  Check("unfinished_robots", float(unfinished), limits["unfinished_robots"]),
                  Check("dropped_neighbours", float(max(r["dropped"] for r in done)),
                        limits["dropped_neighbours"]),
                  Check("goal_miss_m", goal_miss, finish_m)]
    if ctx.control:
        out.control = [Check("pos_gap_m", control_gap, limits["pos_gap_m"])]
    return out

"""Headline benchmark of the port: GBP message updates/s on one card (the
counterpart of the repo's bench.py, with its workload, count and line).

    python -m magics_tpu_torch.bench.headline [sender|receiver|receiver_compact]

Workload (bench.py:31-71): the Circle Experiment scaled up, R=1024 robots
on an 800 m circle crossing to the antipodal point at 15 m/s, 5 s horizon
(V=21), 50 internal + 10 external slots a 10 Hz tick (interleave-evenly),
K=32, comms radius 50 m, tracking off, an all-ones SDF; built on the card
with the kernels on. The exchange defaults to "receiver_compact", as in
bench.py.

bench.py's `jax.jit(partial(run_ticks, n=20))` is a chunk of 20 ticks
captured as one CUDA graph (graph/chunk.py:compile_ticks). After the
capture (which runs one eager chunk to warm up), 2 warm chunks, then 3
timed ones, each followed by a scalar fetch as bench.py's are. The first
line is bench.py's (bench.py:118-131: its keys and unit string); the second
gives each timed chunk's seconds, the card's name and power limit, and the
capture's seconds.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from magics_tpu_torch.graph.chunk import compile_ticks
from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

R = 1024
SPEED = 15.0
N_TICKS = 20
WARM = 2
REPS = 3


def bench_scenario(exchange: str = "receiver_compact", **overrides):
    """The bench.py workload, built by the port with its defaults (on the
    card, the GBP slots through the kernels) unless `overrides`, further
    arguments of `build_scenario`, say otherwise."""
    return build_scenario(
        circle_formation(R, circle_radius=800.0, target_speed=SPEED),
        target_speed=SPEED,
        planning_horizon=5.0,
        hz=10.0,
        comms_radius=50.0,
        internal=50,
        external=10,
        schedule=ScheduleKind.INTERLEAVE_EVENLY,
        n_slots=32,
        world=(2000.0, 2000.0),
        sdf=np.ones((128, 128)),
        dtype=torch.float32,
        despawn_on_final_waypoint=False,
        tracking_enabled=False,
        ext_exchange=exchange,
        **overrides,
    )


def metric_line(params, n_robots: int, mean_degree: float, overflow: int,
                ticks_per_s: float) -> dict:
    """bench.py's metric line (bench.py:96-131): the messages a tick sends,
    counted per robot (internal slot 2 x the internal factors' messages +
    K_active (V-1); external slot 2 K_active (V-1)), times ticks per
    second; its keys and unit string."""
    V = params.n_vars
    n_internal = sum(1 for i, _ in params.schedule if i)
    n_external = sum(1 for _, e in params.schedule if e)
    per_factor = 0
    if params.dynamic_enabled:
        per_factor += 2 * (V - 1)
    if params.obstacle_enabled:
        per_factor += V - 2
    if params.tracking_enabled:
        per_factor += V - 2
    internal_msgs = 2 * per_factor + mean_degree * (V - 1)
    external_msgs = 2 * mean_degree * (V - 1)
    msgs_per_tick = n_robots * (n_internal * internal_msgs + n_external * external_msgs)
    return {
        "metric": "gbp_message_updates_per_s",
        "value": round(msgs_per_tick * ticks_per_s),
        "unit": (
            f"messages/s (R={n_robots}, V={V}, {n_internal}i+{n_external}e "
            f"per tick, mean_degree={mean_degree:.1f}, "
            f"nbr_overflow={overflow})"
        ),
        "vs_baseline": round(ticks_per_s / params.hz, 3),
    }


def measure(exchange: str = "receiver_compact") -> dict:
    """Build, capture, warm and time the workload; returns the metric line,
    the seconds of each timed chunk and of the capture, and the graph."""
    params, state, sdf = bench_scenario(exchange)
    t0 = time.perf_counter()
    graph = compile_ticks(state, sdf, params, N_TICKS)
    capture_s = time.perf_counter() - t0
    del state
    for _ in range(WARM):
        graph.replay()
        int(graph.state.tick)
    rep_s = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        graph.replay()
        int(graph.state.tick)
        rep_s.append(time.perf_counter() - t0)
    ticks_per_s = REPS * N_TICKS / sum(rep_s)
    final = graph.state
    line = metric_line(params, final.n_robots, float(final.nbr_mask.sum()) / final.n_robots,
                       int(final.nbr_overflow), ticks_per_s)
    return {"line": line, "rep_s": rep_s,
            "capture_s": capture_s, "graph": graph, "params": params}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    exchange = argv[0] if argv else "receiver_compact"
    if not torch.cuda.is_available():
        raise SystemExit("the headline benchmark runs on a CUDA card: "
                         "torch.cuda.is_available() is false")
    from magics_tpu_torch.bench.scale import card

    m = measure(exchange)
    print(json.dumps(m["line"]), flush=True)
    print(json.dumps({
        "rep_s": m["rep_s"], "ticks_per_rep": N_TICKS, "runner": "graph",
        "ext_exchange": exchange, "capture_s": m["capture_s"], "card": card(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Swarm-scale benchmark of the port: robots planned in real time on one
card (the counterpart of the JAX package's bench/scale.py, with its
workload).

    python -m magics_tpu_torch.bench.scale [R1,R2,...] [sender|receiver|receiver_compact]

Sweeps R (default 1024, 4096, 8192, 16384) on the Circle workload: robots
4.9 m apart on a circle of radius max(200, R 4.9 / 2 pi) in a world 2.6
times that, at 15 m/s with a 5 s horizon (V=21) at 10 Hz, the reference's
default iteration budget of 10 internal + 10 external slots a tick
(CENTERED), K=24 slots, comms radius 50 m, and grid connectivity and
collisions (cell 50 m, capacity 32, 8 collision partners) so that the pair
search stays O(R). The exchange defaults to "receiver_compact".

Each R is built on the card with the kernels on, and its 10-tick chunks run
as one CUDA graph (graph/chunk.py:compile_ticks, the counterpart of
`jax.jit(partial(run_ticks, n=10))`): the capture (with its eager warm-up
chunk), one warm chunk, then 3 timed chunks, each ending in a
synchronise. One line per R: ms per tick, the multiple of real time (the
10 Hz deadline is 100 ms), the capture's seconds, the mean degree and the
two overflow counters, which must stay 0; the card's name and power limit
come first.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from magics_tpu_torch.graph.chunk import compile_ticks
from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

SIZES = (1024, 4096, 8192, 16384)
SPEED = 15.0
HZ = 10.0
CHUNK = 10
REPS = 3


def scale_scenario(R: int, exchange: str = "receiver_compact", device="cuda"):
    """(params, state, sdf) of the scale workload at R robots: 4.9 m
    spacing keeps ~20 robots inside the 50 m comms radius, so the 24 slots
    cover the in-range degree (nbr_overflow stays 0)."""
    circle_radius = max(200.0, R * 4.9 / (2 * np.pi))
    world = 2.6 * circle_radius
    return build_scenario(
        circle_formation(R, circle_radius=circle_radius, target_speed=SPEED),
        target_speed=SPEED,
        planning_horizon=5.0,
        hz=HZ,
        comms_radius=50.0,
        internal=10,
        external=10,
        schedule=ScheduleKind.CENTERED,
        n_slots=24,
        world=(world, world),
        sdf=np.ones((128, 128)),
        dtype=torch.float32,
        device=device,
        despawn_on_final_waypoint=False,
        ext_exchange=exchange,
        grid_cell_size=50.0,
        grid_capacity=32,
        collision_partners=8,
    )


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run_chunks(graph, reps: int) -> float:
    """Seconds of `reps` replays, each ending in a synchronise (host clock)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        graph.replay()
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def measure(R: int, exchange: str = "receiver_compact") -> dict:
    """Build, capture and time one R; returns the numbers of its line and
    the graph."""
    params, state, sdf = scale_scenario(R, exchange)
    t0 = time.perf_counter()
    graph = compile_ticks(state, sdf, params, CHUNK)
    capture_s = time.perf_counter() - t0
    run_chunks(graph, 1)
    ms = 1e3 * run_chunks(graph, REPS) / (REPS * CHUNK)
    final = graph.state
    return {
        "R": R, "exchange": exchange, "ms_per_tick": ms, "x_real_time": (1e3 / HZ) / ms,
        "capture_s": capture_s, "mean_degree": float(final.nbr_mask.sum()) / R,
        "nbr_overflow": int(final.nbr_overflow), "grid_overflow": int(final.grid_overflow),
        "graph": graph, "params": params, "sdf": sdf,
    }


def line(m: dict) -> str:
    """bench/scale.py's line."""
    return (
        f"R={m['R']:6d}  {m['ms_per_tick']:8.2f} ms/tick  {m['x_real_time']:7.2f}x real-time  "
        f"(capture {m['capture_s']:.0f}s, mean_degree {m['mean_degree']:.2f}, "
        f"nbr_overflow {m['nbr_overflow']}, grid_overflow {m['grid_overflow']})"
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sizes = [int(x) for x in argv[0].split(",")] if argv else list(SIZES)
    exchange = argv[1] if len(argv) > 1 else "receiver_compact"
    if not torch.cuda.is_available():
        raise SystemExit("the scale benchmark runs on a CUDA card: torch.cuda.is_available() "
                         "is false")
    print(f"{card()} | {torch.cuda.get_device_name(0)} | ext_exchange={exchange}", flush=True)
    for R in sizes:
        m = measure(R, exchange)
        print(line(m), flush=True)
        del m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Component-level timing of the headline workload (counterpart of the JAX
package's bench/profile_tick.py).

Times the full tick and ablations (internal-only / external-only
schedules, the plain passes, grid connectivity, no inter-robot factors) on
the R=1024 circle of the JAX tool, so regressions can be localised:

    python -m magics_tpu_torch.bench.profile_tick [R] [--variants=a,b,...] \\
        [--platform cuda|cpu] [--ticks N]

The variants are the JAX tool's, on the port's GbpParams. "pallas" asked
the JAX tick for its Pallas kernels against an XLA baseline; the port's
baseline runs its kernels, so here "pallas" asks for `use_pallas=False`,
the plain PyTorch passes. "scan" changes nothing in the port (it unrolls
the schedule either way) and is kept for the comparison.

On the card each variant runs as N-tick CUDA graphs (graph/chunk.py:
compile_ticks) and eagerly (`run_ticks`), each chunk timed by CUDA events
after a warm chunk: one line per variant, ms/tick of both and the
capture's seconds. On the CPU (`--platform cpu`) only the eager chunks
run, timed on the host clock: the CPU's times, never the card's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build(R: int, *, internal: int = 50, external: int = 10, device="cuda", **over):
    """The JAX tool's workload: R robots on a 200 m circle at 15 m/s, 5 s
    horizon at 10 Hz, comms 50 m, K=8, interleave-evenly, all-ones SDF."""
    from magics_tpu_torch.core.schedule import ScheduleKind
    from magics_tpu_torch.sim.builder import build_scenario, circle_formation

    speed = 15.0
    return build_scenario(
        circle_formation(R, circle_radius=200.0, target_speed=speed),
        target_speed=speed, planning_horizon=5.0, hz=10.0, comms_radius=50.0,
        internal=internal, external=external, schedule=ScheduleKind.INTERLEAVE_EVENLY,
        n_slots=8, world=(500.0, 500.0), sdf=np.ones((128, 128)), dtype=torch.float32,
        device=device, despawn_on_final_waypoint=False, **over,
    )


def chunk_ms(run, reps: int, device: torch.device) -> float:
    """Milliseconds of each of `reps` calls of `run` (after one warm call):
    by CUDA events on the card, else the host clock. The median."""
    run()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def time_variant(name: str, params, state, sdf, n_ticks: int = 20, reps: int = 3) -> dict:
    """ms/tick of `n_ticks`-tick chunks: eager, and on the card as one CUDA
    graph. Prints the variant's line and returns its numbers."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.graph.chunk import compile_ticks

    device = state.device
    box = [state]

    def eager():
        box[0] = T.run_ticks(box[0], sdf, params, n_ticks)

    out = {"eager_ms": chunk_ms(eager, reps, device) / n_ticks}
    if device.type == "cuda":
        t0 = time.perf_counter()
        graph = compile_ticks(box[0], sdf, params, n_ticks)
        out["capture_s"] = time.perf_counter() - t0
        out["graph_ms"] = chunk_ms(graph.replay, reps, device) / n_ticks
        print(f"{name:28s} {out['graph_ms']:9.3f} ms/tick graph  {out['eager_ms']:9.3f} "
              f"ms/tick eager  (capture {out['capture_s']:.1f}s; CUDA events)", flush=True)
    else:
        print(f"{name:28s} {out['eager_ms']:9.3f} ms/tick eager  (cpu, host clock)",
              flush=True)
    return out


VARIANTS = {
    "baseline": {},
    "internal_only": dict(internal=50, external=0),
    "external_only": dict(internal=0, external=10),
    "no_gbp": dict(internal=0, external=0),
    "pallas": dict(use_pallas=False),
    "grid": dict(grid_cell_size=50.0, grid_capacity=64, collision_partners=8),
    "scan": dict(scan_schedule=True),
    "no_interrobot": dict(interrobot_enabled=False),
}


def parse(argv, doc: str, names) -> argparse.Namespace:
    """The tools' common arguments: [R] [--variants=a,b] [--platform]
    [--ticks]."""
    p = argparse.ArgumentParser(description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("robots", nargs="?", type=int, default=1024)
    p.add_argument("--variants", default=None, help=f"a comma list of {', '.join(names)}")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--ticks", type=int, default=20)
    args = p.parse_args(argv)
    args.variants = args.variants.split(",") if args.variants else list(names)
    unknown = set(args.variants) - set(names)
    if unknown:
        p.error(f"unknown variants {sorted(unknown)}")
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda asked for, but torch.cuda.is_available() is false; "
                         "pass --platform cpu to run on the CPU")
    if args.platform == "cuda":
        print(f"# {torch.cuda.get_device_name(0)}", flush=True)
    return args


def main(argv=None) -> int:
    args = parse(argv, __doc__, VARIANTS)
    for name in args.variants:
        params, state, sdf = build(args.robots, device=args.platform, **VARIANTS[name])
        time_variant(name, params, state, sdf, args.ticks)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measured cost of the port's robot-sharded exchange (counterpart of the
JAX package's bench/multichip_cost.py).

The JAX tool reads the collective traffic out of the compiled HLO. The port
has no compiled program, so it counts what its `ShardComm` moves: a
`CountingComm` tallies the output bytes of every all_gather and all_reduce
a tick, by call site, and the tool holds the exchange's share to the
traffic model the JAX tool validates (magics_tpu bench/multichip_cost.py:
14-18): per external pass the sender path all-gathers the [R, K, V-1, 4]
outbox, 16 R K (V-1) bytes; the receiver-computes path the [R, V-1, 8]
compact cavity tables, 32 R (V-1) bytes, independent of K. The two must be
equal, exactly. Beside the bytes it prints ms/tick at each shard count and
of the one-process tick, eager, on the host clock ending in a synchronise.

    python -m magics_tpu_torch.bench.multichip_cost [R1,R2,...] [shards1,...] \\
        [sender|receiver_compact|both] [--platform cuda|cpu] [--backend nccl|gloo] \\
        [--ticks N]

Defaults: R 1024, shards 1,2,4, both exchanges, 3 timed ticks, the card
over nccl (one card per rank: ranks sharing one card ask for gloo). The
ranks are fresh processes (parallel/launch.py:spawn_ranks). On the CPU the
times are the CPU's, never the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from magics_tpu_torch.parallel.launch import (
    exchange_bytes,
    exchange_model_bytes,
    spawn_ranks,
    timed_ticks,
)


def build(R: int, ext: str, device):
    """The JAX tool's workload: bench/scale.py's circle (4.9 m spacing,
    15 m/s, 5 s horizon at 10 Hz, 10 + 10 CENTERED slots, K=24, comms 50 m,
    grid cell 50 m, capacity 32, 8 partners), no event rings, no logs."""
    from magics_tpu_torch.core.schedule import ScheduleKind
    from magics_tpu_torch.sim.builder import build_scenario, circle_formation

    speed = 15.0
    circle_radius = max(200.0, R * 4.9 / (2 * np.pi))
    world = 2.6 * circle_radius
    return build_scenario(
        circle_formation(R, circle_radius=circle_radius, target_speed=speed),
        target_speed=speed, planning_horizon=5.0, hz=10.0, comms_radius=50.0,
        internal=10, external=10, schedule=ScheduleKind.CENTERED, n_slots=24,
        world=(world, world), sdf=np.ones((128, 128)), dtype=torch.float32, device=device,
        despawn_on_final_waypoint=False, ext_exchange=ext, grid_cell_size=50.0,
        grid_capacity=32, collision_partners=8, collision_log_capacity=0, log_every=0,
    )


def _device(platform: str, rank: int) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def measure_rank(rank: int, n: int, R: int, ext: str, platform: str, ticks: int,
                 out: str) -> None:
    """One rank (run by spawn_ranks): its part of the workload through the
    sharded step with a CountingComm; rank 0 writes its numbers to `out`."""
    from magics_tpu_torch.parallel.comm import CountingComm, ShardComm
    from magics_tpu_torch.parallel.shard_tick import make_shard_step, shard_state

    device = _device(platform, rank)
    params, state, sdf = build(R, ext, device)
    counting = CountingComm(ShardComm.of_group(R))
    step = make_shard_step(params, R, comm=counting)
    _, rep = timed_ticks(step, shard_state(state, rank, n), sdf, ticks, counting, device)
    rep["exchange_bytes_per_tick"] = exchange_bytes(counting, params, ticks)
    rep["model_bytes_per_tick"] = exchange_model_bytes(params, R)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rep, f)


def one_process_ms(R: int, ext: str, platform: str, ticks: int) -> float:
    """ms/tick of the one-process (LOCAL) tick on the same workload."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.parallel.comm import LOCAL, CountingComm

    device = _device(platform, 0)
    params, state, sdf = build(R, ext, device)
    counting = CountingComm(LOCAL)

    def step(state, sdf, generator=None):
        return T.run_ticks(state, sdf, params, 1, None, counting, generator)

    return timed_ticks(step, state, sdf, ticks, counting, device)[1]["ms_per_tick"]


def measure(R: int, n: int, ext: str, platform: str = "cuda", backend: str = "nccl",
            ticks: int = 3, timeout: float = 600.0) -> dict:
    """The n-rank numbers of one workload (see measure_rank); raises where
    the exchange's bytes differ from the traffic model."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        spawn_ranks(measure_rank, n, (R, ext, platform, ticks, out), backend=backend,
                    timeout=timeout)
        with open(out) as f:
            rep = json.load(f)
    if rep["exchange_bytes_per_tick"] != rep["model_bytes_per_tick"]:
        raise AssertionError(
            f"R={R} {n} ranks {ext}: the exchange all-gathers "
            f"{rep['exchange_bytes_per_tick']} bytes a tick, the model says "
            f"{rep['model_bytes_per_tick']}"
        )
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("robots", nargs="?", default="1024")
    p.add_argument("shards", nargs="?", default="1,2,4")
    p.add_argument("exchange", nargs="?", default="both",
                   choices=("sender", "receiver_compact", "both"))
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--ticks", type=int, default=3)
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda asked for, but torch.cuda.is_available() is false; "
                         "pass --platform cpu to run on the CPU")
    exts = ["sender", "receiver_compact"] if args.exchange == "both" else [args.exchange]
    where = (f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
             if args.platform == "cuda" else "cpu (times are the CPU's)")
    print(f"# {where}; backend {args.backend}; {args.ticks} timed eager ticks, host clock",
          flush=True)
    print("# R  shards  exchange          exchange_MB/tick  model_MB  other_MB  "
          "shard_ms  one_process_ms  ratio", flush=True)
    for R in (int(x) for x in args.robots.split(",")):
        for ext in exts:
            local_ms = one_process_ms(R, ext, args.platform, args.ticks)
            for n in (int(x) for x in args.shards.split(",")):
                if R % n:
                    continue
                rep = measure(R, n, ext, args.platform, args.backend, args.ticks)
                ex = rep["exchange_bytes_per_tick"]
                other = rep["collective_bytes_per_tick"] - ex
                ms = rep["ms_per_tick"]
                print(f"{R:6d}  {n}  {ext:16s}  {ex / 1e6:14.3f}  "
                      f"{rep['model_bytes_per_tick'] / 1e6:8.3f}  {other / 1e6:8.3f}  "
                      f"{ms:8.2f}  {local_ms:14.2f}  {ms / local_ms:5.2f}", flush=True)
                print("#   by call site, bytes/tick: " + json.dumps(rep["bytes_per_tick"]),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process launcher of the port's robot-sharded tick (counterpart of
magics_tpu's parallel/launch.py).

Every rank runs this same program: `initialize()` joins the
`torch.distributed` process group the environment describes, each rank
builds the whole scenario, keeps its R / n robots (`shard_state`) and runs
the eager `run_ticks` with a `ShardComm` (parallel/shard_tick.py); every
cross-robot exchange is a collective.

Environment (the JAX launcher's variables first, then torchrun's):
    MAGICS_COORDINATOR   host:port of rank 0's rendezvous
    MAGICS_NUM_PROCESSES the number of ranks
    MAGICS_PROCESS_ID    this process's rank
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT   as torchrun sets them
With neither set it runs as one process with the LOCAL comm.

Usage:
    # one card per rank over NCCL (the default)
    torchrun --nproc-per-node 2 -m magics_tpu_torch.parallel.launch --robots 16384
    # two ranks sharing one card, or on the CPU: gloo, asked for by name
    MAGICS_COORDINATOR=localhost:29511 MAGICS_NUM_PROCESSES=2 MAGICS_PROCESS_ID=0 \\
        python -m magics_tpu_torch.parallel.launch --backend gloo [--platform cpu] ...

`--platform cuda` (the default) raises without a card; `--backend nccl`
(the default) takes one card per rank, `cuda:rank % device_count`, and
raises where there are fewer cards than ranks. Nothing falls back on its
own. The kernels build once, on rank 0, before the ranks start their ticks.

Rank 0 prints `processes=N backend=... device=...` and
`R=... shards=... X ms/tick (Yx 10 Hz real-time)`; every rank prints one
`rank_report {json}` line (its ms/tick, its kernel launches a tick, which
it asserts against the schedule, and the bytes its collectives return a
tick by call site beside the exchange's traffic model); with --check-sum
every rank prints `rank=r abs_pos_sum=...`, the global sum from one
all_reduce, which all ranks must agree on.

`spawn_ranks` runs a function in n fresh processes of one process group;
`entry.dryrun_multichip`, bench/multichip_cost.py and the tests use it.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import multiprocessing
import multiprocessing.connection
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

#: a collective that waits longer than this raises
TIMEOUT_S = 300.0

KERNEL_NAMES = {"internal_slot": "internal_slot_kernel", "variable_slot": "variable_slot_kernel",
                "interrobot_slot": "interrobot_slot_kernel", "gather_rows": "gather_rows_kernel"}


def _device(platform: str, backend: str, rank: int, world: int) -> torch.device:
    """The device of `rank`: the CPU, or card rank % device_count; raises
    where the platform or backend asks for cards that are not there."""
    if platform == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs the card; use --backend gloo on the CPU")
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"unknown platform {platform!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--platform cuda asked for, but torch.cuda.is_available() is false; "
            "pass --platform cpu to run on the CPU"
        )
    count = torch.cuda.device_count()
    if backend == "nccl" and count < world:
        raise RuntimeError(
            f"nccl takes one card per rank: {world} ranks, {count} card(s); "
            "ask for --backend gloo to share a card"
        )
    return torch.device("cuda", rank % count)


def initialize(backend: str = "nccl", platform: str = "cuda") -> tuple[int, int, torch.device]:
    """Join the process group the environment describes (idempotent) and
    return (rank, world size, this rank's device). (0, 1, device) and no
    group where neither the MAGICS_* nor torchrun's variables are set."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        return rank, world, _device(platform, backend, rank, world)
    env = os.environ
    coord = env.get("MAGICS_COORDINATOR")
    nproc, pid = env.get("MAGICS_NUM_PROCESSES"), env.get("MAGICS_PROCESS_ID")
    if coord and nproc is not None and pid is not None:
        init, rank, world = f"tcp://{coord}", int(pid), int(nproc)
    elif "RANK" in env and "WORLD_SIZE" in env:
        init, rank, world = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return 0, 1, _device(platform, backend, 0, 1)
    device = _device(platform, backend, rank, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return rank, world, device


def _rank_main(target, rank: int, n_ranks: int, init: str, backend: str, args: tuple) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        target(rank, n_ranks, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, n_ranks: int, args: tuple = (), *, backend: str = "gloo",
                timeout: float = 300.0) -> None:
    """Run `target(rank, n_ranks, *args)` in `n_ranks` fresh processes (the
    'spawn' start method; `target` must be importable) that form one
    process group of `backend`, meeting at a file in a temporary directory.
    Raises if a rank exits non-zero or the ranks have not all ended within
    `timeout` seconds; the ranks left are then killed."""
    if backend == "nccl" and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < n_ranks):
        raise RuntimeError(
            f"nccl takes one card per rank: {n_ranks} ranks, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} card(s)"
        )
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank_main, args=(target, r, n_ranks, init, backend, args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            running = list(procs)
            while running and time.monotonic() < deadline:
                multiprocessing.connection.wait([p.sentinel for p in running],
                                                deadline - time.monotonic())
                running = [p for p in running if p.exitcode is None]
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{n_ranks} ranks of {getattr(target, '__name__', target)}: "
                           f"exit codes {codes} (a negative code is a signal; "
                           f"{timeout:g} s allowed)")


def expected_launches(params, device: torch.device) -> dict[str, int]:
    """Kernel launches a tick of `params`' schedule on `device`: one K1 per
    internal slot and one K2 per external slot where the slot kernels run,
    under "sender" one K3 and two row gathers (K4) per external slot,
    under the receiver exchanges one K4; none on the CPU."""
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e) if params.interrobot_enabled else 0
    slots = params.uses_kernels(device)
    sender = params.ext_exchange == "sender"
    cuda = device.type == "cuda"
    return {
        "internal_slot": n_int if slots else 0,
        "variable_slot": n_ext if slots else 0,
        "interrobot_slot": n_ext if slots and sender else 0,
        "gather_rows": (2 if sender else 1) * n_ext if cuda else 0,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ticks(step, state, sdf, n_ticks: int, comm, device, generator=None):
    """One warm-up tick from a copy of `state` (the generator put back
    where it was), then `n_ticks` ticks of `step(state, sdf, generator)`
    from `state` itself, timed on the host clock from a barrier to a
    synchronise. `comm` is a CountingComm inside `step`. Returns the final
    state and {"ms_per_tick", "launches_per_tick", "bytes_per_tick" by call
    site and op, "collective_bytes_per_tick"}."""
    from magics_tpu_torch.graph.chunk import clone_state
    from magics_tpu_torch.kernels import launch_counts, reset_launch_counts

    g_state = generator.get_state() if generator is not None else None
    step(clone_state(state), sdf, generator)
    if generator is not None:
        generator.set_state(g_state)
    _sync(device)
    if dist.is_initialized():
        dist.barrier()
    comm.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        state = step(state, sdf, generator)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / n_ticks
    counts = launch_counts()
    by_site = {k: v / n_ticks for k, v in comm.by_site().items()}
    return state, {
        "ms_per_tick": ms,
        "launches_per_tick": {k: v / n_ticks for k, v in counts.items()},
        "bytes_per_tick": by_site,
        "collective_bytes_per_tick": sum(by_site.values()),
    }


def exchange_table_shape(params) -> tuple[int, ...]:
    """The per-robot shape of the table the external pass all_gathers:
    the sender's outbox [K, V-1, 4], the receiver's snapshot pack
    [V-1, 24], receiver_compact's cavity tables [V-1, 8]."""
    V1 = params.n_vars - 1
    return {"sender": (params.n_slots, V1, 4), "receiver": (V1, 24),
            "receiver_compact": (V1, 8)}[params.ext_exchange]


def exchange_model_bytes(params, n_robots: int) -> int:
    """The traffic model of magics_tpu bench/multichip_cost.py:14-18, a
    tick: per external pass the exchange's table for all R robots,
    16 R K (V-1) bytes under "sender", 32 R (V-1) under "receiver_compact"
    (float32)."""
    n_ext = sum(1 for _, e in params.schedule if e) if params.interrobot_enabled else 0
    itemsize = torch.empty((), dtype=params.dtype).element_size()
    per_robot = 1
    for d in exchange_table_shape(params):
        per_robot *= d
    return n_ext * n_robots * per_robot * itemsize


def exchange_bytes(counting, params, n_ticks: int = 1) -> float:
    """Bytes a tick of the all_gathers of the exchange's table, from a
    CountingComm's tally over `n_ticks` ticks."""
    shape = exchange_table_shape(params)
    return sum(b for (_, op, _, s), b in counting.bytes.items()
               if op == "all_gather" and s[1:] == shape) / n_ticks


def launch_workload(R: int, slots: int, internal: int, external: int, exchange: str, device):
    """The JAX launcher's workload (magics_tpu parallel/launch.py:100-123):
    a circle at 4.9 m spacing, 15 m/s, 5 s horizon at 10 Hz, comms 50 m,
    grid connectivity and collisions."""
    import numpy as np

    from magics_tpu_torch.sim.builder import build_scenario, circle_formation

    speed = 15.0
    circle_radius = max(200.0, R * 4.9 / (2 * np.pi))
    return build_scenario(
        circle_formation(R, circle_radius=circle_radius, target_speed=speed),
        target_speed=speed, planning_horizon=5.0, hz=10.0, comms_radius=50.0,
        internal=internal, external=external, n_slots=slots,
        world=(2.6 * circle_radius, 2.6 * circle_radius), dtype=torch.float32,
        device=device, despawn_on_final_waypoint=False, ext_exchange=exchange,
        grid_cell_size=50.0, grid_capacity=32, collision_partners=8,
    )


def _profile_tick(step, state, sdf, generator, rank: int) -> dict | None:
    """Device us per launch of each kernel in one more tick, from rank 0's
    torch.profiler (the other ranks run the tick beside it, unprofiled)."""
    from magics_tpu_torch.graph.chunk import clone_state
    from magics_tpu_torch.profiling import profile

    state = clone_state(state)
    if rank != 0:
        step(state, sdf, generator)
        torch.cuda.synchronize()
        return None
    prof = profile(lambda: step(state, sdf, generator), attempts=1, required=False)
    if prof is None:
        return None
    out = {}
    for name, kname in KERNEL_NAMES.items():
        hits = [(n, us) for key, (n, us) in prof["kernels"].items() if kname in key]
        count = sum(n for n, _ in hits)
        if count:
            out[name] = sum(us for _, us in hits) / count
    return {"kernel_device_us": out, "device_us": prof["device_us"],
            "launches": prof["launches"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--robots", type=int, default=1024)
    p.add_argument("--ticks", type=int, default=20)
    p.add_argument("--slots", type=int, default=24)
    p.add_argument("--internal", type=int, default=10)
    p.add_argument("--external", type=int, default=10)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--seed", type=int, default=0,
                   help="seed of every rank's comms-failure generator (the same on all)")
    p.add_argument("--exchange", default="sender",
                   choices=("sender", "receiver", "receiver_compact"))
    p.add_argument("--workload", default="launch", choices=("launch", "scale"),
                   help="launch: the JAX launcher's (--slots, --internal, --external); "
                   "scale: bench/scale.py's (K=24, 10 + 10 CENTERED slots, tracking on)")
    p.add_argument("--save", default=None,
                   help="rank 0 writes the gathered final state here (torch.save)")
    p.add_argument("--profile", action="store_true",
                   help="one more tick under rank 0's torch.profiler (card only): "
                   "each kernel's device us per launch")
    p.add_argument("--check-sum", action="store_true",
                   help="every rank prints the global sum of |positions| "
                   "(cross-process agreement check)")
    args = p.parse_args(argv)

    rank, world, device = initialize(args.backend, args.platform)

    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.parallel.comm import LOCAL, CountingComm, ShardComm
    from magics_tpu_torch.parallel.shard_tick import gather_state, make_shard_step, shard_state

    if device.type == "cuda":
        from magics_tpu_torch.kernels import build

        if rank == 0:
            build.build_all()
        if world > 1:
            dist.barrier()
    if rank == 0:
        print(f"processes={world} backend={args.backend if world > 1 else 'none'} "
              f"device={device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
              flush=True)

    R = args.robots - (args.robots % world) or world
    if args.workload == "scale":
        from magics_tpu_torch.bench.scale import scale_scenario

        params, state, sdf = scale_scenario(R, args.exchange, device)
    else:
        params, state, sdf = launch_workload(R, args.slots, args.internal, args.external,
                                             args.exchange, device)
    comm = ShardComm.of_group(R) if world > 1 else LOCAL
    counting = CountingComm(comm)
    if world > 1:
        state = shard_state(state, rank, world)
        run = make_shard_step(params, R, comm=counting)
    else:
        def run(state, sdf, generator=None):
            return T.run_ticks(state, sdf, params, 1, None, counting, generator)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    out, rep = timed_ticks(run, state, sdf, args.ticks, counting, device, generator)
    expected = expected_launches(params, device)
    got = {k: rep["launches_per_tick"][k] for k in expected}
    if got != expected:
        raise AssertionError(f"rank {rank}: kernel launches a tick {got}, expected {expected}")
    rep.update(rank=rank, R=R, shards=world, backend=args.backend if world > 1 else None,
               device=str(device), exchange=args.exchange, workload=args.workload,
               exchange_bytes_per_tick=exchange_bytes(counting, params, args.ticks),
               model_bytes_per_tick=exchange_model_bytes(params, R) if world > 1 else 0)
    if args.profile and device.type == "cuda":
        rep["profile"] = _profile_tick(run, out, sdf, generator, rank)
    print("rank_report " + json.dumps(rep), flush=True)
    if rank == 0:
        ms = rep["ms_per_tick"]
        print(f"R={R} shards={world} {ms:.2f} ms/tick ({1e3 / params.hz / ms:.2f}x "
              f"{params.hz:g} Hz real-time)", flush=True)
    if args.save:
        full = gather_state(out, comm)
        if rank == 0:
            torch.save({f.name: getattr(full, f.name).cpu() for f in dataclasses.fields(full)},
                       args.save)
        del full
    if args.check_sum:
        total = comm.psum(out.pos.abs().sum(dtype=torch.float64))
        print(f"rank={rank} abs_pos_sum={float(total):.4f}", flush=True)
    if world > 1:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

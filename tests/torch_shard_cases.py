"""Scenarios of the port's robot-sharded tick for tests/test_torch_shard.py,
and the function each rank runs (parallel/launch.py:spawn_ranks starts it
in fresh processes, so this module imports no JAX).

The scenarios are those of tests/test_shard_tick.py:56-104 (16 robots,
float64, on the CPU; the grid one on a tighter circle), the
receiver_compact exchange and a dense circle whose robots collide; for the
comparison with the JAX package's shard_map tick, a perturbed circle (1%
per robot: no exact distance ties, ROADMAP F2) with no comms failure.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

R = 16
N_TICKS = 5
SEED = 11
#: the card test's ranks: bench/scale.py's workload at 1024 robots
CARD_R = 1024
CARD_TICKS = 3


def _circle(module, perturb: bool, target_speed: float, radius: float):
    specs = module.circle_formation(R, circle_radius=radius, target_speed=target_speed)
    if perturb:
        for i, s in enumerate(specs):
            s.start[:2] *= 1.0 + 0.01 * i
            s.waypoints[0, :2] *= 1.0 + 0.01 * i
    return specs


_BASE = dict(target_speed=8.0, planning_horizon=1.0, comms_radius=60.0,
             internal=3, external=2, n_slots=4)

#: case -> (build_scenario keyword arguments, env_dist or None)
CASES = {
    "dense": dict(comms_failure_rate=0.2),
    "hot": dict(comms_failure_rate=0.1, use_pallas=True),
    "logs_goal_areas": dict(
        comms_failure_rate=0.1, log_every=2, log_capacity=8, viz_log_capacity=4,
        goal_areas=np.array([[-30.0, -30.0, 30.0, 30.0]]),
    ),
    "receiver_compact": dict(comms_failure_rate=0.2, ext_exchange="receiver_compact"),
    "grid_env": dict(
        comms_radius=30.0, comms_failure_rate=0.2, grid_cell_size=15.0, grid_capacity=8,
        collision_partners=4, world=(120.0, 120.0), circle_radius=8.0,
    ),
    # robots 3.1 m apart, 2 m wide: robot-robot collisions from the start,
    # so the column counts of `scatter_rows` carry other ranks' pairs
    "dense_collisions": dict(comms_failure_rate=0.2, circle_radius=8.0),
}
#: cases held to the JAX shard_map tick: tests/test_torch_tick.py's
#: crossing (a perturbed circle, horizons that reach across it, so the
#: inter-robot factors engage in the first tick), no comms failure
_CROSSING = dict(target_speed=15.0, planning_horizon=3.0, comms_radius=20.0, internal=6,
                 external=3, n_slots=8, world=(200.0, 200.0), sdf=np.ones((64, 64)),
                 tracking_enabled=False, despawn_on_final_waypoint=False)
JAX_CASES = {
    "jax_sender": dict(_CROSSING, ext_exchange="sender"),
    "jax_receiver_compact": dict(_CROSSING, ext_exchange="receiver_compact"),
}


def env_dist(case: str):
    """The grid case's distance field: an obstacle block over the robots'
    start circle (the middle 60 m of the 120 m world), so environment
    collisions fire."""
    if case != "grid_env":
        return None
    d = np.full((16, 16), 100.0)
    d[4:12, 4:12] = 0.0
    return d


def build(module, case: str, **extra):
    """(params, state, sdf) of `case` from a builder module (the port's
    `magics_tpu_torch.sim.builder` or the JAX package's)."""
    kw = {**_BASE, **CASES.get(case, JAX_CASES.get(case, {})), **extra}
    radius = kw.pop("circle_radius", 20.0)
    specs = _circle(module, case in JAX_CASES, kw["target_speed"], radius)
    return module.build_scenario(specs, **kw)


def port_build(case: str, **extra):
    from magics_tpu_torch.sim import builder

    return build(builder, case, dtype=torch.float64, device="cpu", **extra)


def n_ticks(case: str) -> int:
    return 1 if case in JAX_CASES else N_TICKS


def port_run(case: str, comm=None):
    """The port's run of `case`: with `comm` None one process over all
    robots, else this rank's part under `comm`, gathered. Every rank seeds
    its generator alike."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.parallel.shard_tick import gather_state, make_shard_step, shard_state

    params, state, sdf = port_build(case)
    ed = env_dist(case)
    ed = None if ed is None else torch.as_tensor(ed)
    gen = torch.Generator().manual_seed(SEED)
    if comm is None:
        return T.run_ticks(state, sdf, params, n_ticks(case), ed, generator=gen)
    fn = make_shard_step(params, R, n_ticks=n_ticks(case), comm=comm,
                         with_env_dist=ed is not None)
    local = shard_state(state, comm.rank, comm.n_shards)
    out = fn(local, sdf, ed, generator=gen) if ed is not None else fn(local, sdf, generator=gen)
    return gather_state(out, comm)


def run_cases(rank: int, n: int, out_dir: str) -> None:
    """One rank: every case under a ShardComm of the group; rank 0 writes
    each gathered final state to <out_dir>/<case>.npz."""
    from magics_tpu_torch.parallel.comm import ShardComm

    comm = ShardComm.of_group(R)
    for case in (*CASES, *JAX_CASES):
        out = port_run(case, comm)
        if rank == 0:
            np.savez(f"{out_dir}/{case}.npz", **{
                f.name: getattr(out, f.name).numpy() for f in dataclasses.fields(out)
            })


def run_card_case(rank: int, n: int, exchange: str, out: str) -> None:
    """One rank on the card (tests/test_torch_kernels_cuda.py): bench/
    scale.py's workload at CARD_R robots, CARD_TICKS eager ticks of this
    rank's part; each rank writes its kernel launches a tick to
    `<out>.launches<rank>`, rank 0 the gathered state to `out` (torch.save)."""
    from magics_tpu_torch.bench.scale import scale_scenario
    from magics_tpu_torch.parallel.comm import CountingComm, ShardComm
    from magics_tpu_torch.parallel.launch import timed_ticks
    from magics_tpu_torch.parallel.shard_tick import gather_state, make_shard_step, shard_state

    device = torch.device("cuda", rank % torch.cuda.device_count())
    params, state, sdf = scale_scenario(CARD_R, exchange, device)
    counting = CountingComm(ShardComm.of_group(CARD_R))
    step = make_shard_step(params, CARD_R, comm=counting)
    final, rep = timed_ticks(step, shard_state(state, rank, n), sdf, CARD_TICKS, counting,
                             device)
    full = gather_state(final, counting)
    torch.save(rep["launches_per_tick"], f"{out}.launches{rank}")
    if rank == 0:
        torch.save({f.name: getattr(full, f.name).cpu() for f in dataclasses.fields(full)}, out)


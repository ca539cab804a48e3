"""The robot-sharded tick over `torch.distributed` (counterpart of
magics_tpu's parallel/shard_tick.py).

Each rank of a process group holds R / n robots and runs the ordinary
`tick.run_ticks` on them with a `ShardComm` (parallel/comm.py): every
cross-robot exchange is an explicit collective (`all_gather` of neighbour
positions, masks, slot tables and message outboxes; `all_reduce` of event
counts and of per-robot column sums). Neighbour ids stay global, so the
kernels K1-K4 run on the local rows unchanged. The result equals the
one-process tick (tests/test_torch_shard.py).

The JAX package has a second way, GSPMD (parallel/sharding.py): place the
state with NamedSharding and let XLA partition the gathers of an ordinary
jitted step. PyTorch has no compiler that partitions an eager program's
gathers into collectives, so that path has no counterpart here; this module
is the multi-device path of the port.

Partition layout (robot axis of each field, by name):
  [R, ...] state tensors, nbr_back, nbr_has_back     -> axis 0
  pairwise hysteresis rr_overlap [R, R]              -> axis 0 (rows local,
                                                        columns global)
  ring-buffer logs [L, R, ...], goal areas [G, R]     -> axis 1
  scalars, event rings, goal-area AABBs               -> replicated

Constraints, as in JAX: R % n_ranks == 0 (pad capacity in the builder), and
the collision event rings off (collision_log_capacity=0): their write order
is global. The sharded step runs eagerly: collectives are not captured in a
CUDA graph (graph/chunk.py:compile_ticks refuses a ShardComm).
"""

from __future__ import annotations

import dataclasses

import torch

from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.graph.state import GbpParams, SimState

# fields whose ROBOT axis is axis 1 (ring buffers, goal-area history)
_ROBOT_AXIS1 = {"pos_log", "vel_log", "viz_mean", "viz_cov", "viz_trk", "ga_history"}
# replicated fields: scalars, goal-area AABBs, event buffers
_REPLICATED = {
    "tick", "log_head",
    "rr_collisions", "re_collisions",
    "rr_event_count", "re_event_count", "rr_partner_overflow", "nbr_overflow",
    "grid_overflow",
    "rr_events", "re_events", "ga_aabb",
}


def state_partition_specs() -> dict[str, int | None]:
    """The robot axis of every SimState field (0 or 1), None where the
    field is replicated on every rank."""
    specs = {}
    for f in dataclasses.fields(SimState):
        if f.name in _REPLICATED:
            specs[f.name] = None
        elif f.name in _ROBOT_AXIS1:
            specs[f.name] = 1
        else:
            specs[f.name] = 0
    return specs


def shard_state(state: SimState, rank: int, n_shards: int) -> SimState:
    """Rank `rank`'s part of a global state: its R / n_shards robots of each
    sharded field (contiguous copies), every replicated field as it is."""
    R = state.n_robots
    if R % n_shards:
        raise ValueError(
            f"robot capacity {R} must divide the {n_shards} ranks (pad `capacity` in the builder)"
        )
    n = R // n_shards
    out = {}
    for name, axis in state_partition_specs().items():
        t = getattr(state, name)
        out[name] = t if axis is None else t.narrow(axis, rank * n, n).contiguous()
    return SimState(**out)


def gather_state(state: SimState, comm) -> SimState:
    """The global state rebuilt from every rank's part (a collective: every
    rank calls it and every rank gets the whole state)."""
    out = {}
    for name, axis in state_partition_specs().items():
        t = getattr(state, name)
        if axis is None:
            out[name] = t
        elif axis == 0:
            out[name] = comm.all_robots(t)
        else:
            out[name] = comm.all_robots(t.movedim(1, 0)).movedim(0, 1).contiguous()
    return SimState(**out)


def make_shard_step(
    params: GbpParams,
    n_robots: int,
    *,
    n_ticks: int = 1,
    comm,
    with_env_dist: bool = False,
):
    """`run_ticks` of `n_ticks` on this rank's part of the state under
    `comm` (a ShardComm of the group). Returns fn(state, sdf[, env_dist],
    generator=None) -> state; `state` is this rank's part (`shard_state`),
    `sdf` and `env_dist` whole on every rank. Where comms failure is on,
    every rank passes a generator seeded alike: each draws all R_total
    robots and keeps its own rows, so the failures do not depend on the
    sharding."""
    n_shards = comm.n_shards
    if n_robots % n_shards or comm.n_local * n_shards != n_robots:
        raise ValueError(
            f"robot capacity {n_robots} must divide the {n_shards} ranks "
            f"of {comm.n_local} robots each (pad `capacity` in the builder)"
        )
    if params.collision_log_capacity > 0:
        raise ValueError(
            "collision_log_capacity must be 0 for the sharded tick "
            "(event ring-buffer write order is global)"
        )

    if with_env_dist:
        def fn(state, sdf, env_dist, generator: torch.Generator | None = None):
            return T.run_ticks(state, sdf, params, n_ticks, env_dist, comm, generator)
    else:
        def fn(state, sdf, generator: torch.Generator | None = None):
            return T.run_ticks(state, sdf, params, n_ticks, None, comm, generator)
    return fn

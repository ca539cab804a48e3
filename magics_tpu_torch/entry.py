"""Entry points of the port (counterpart of __graft_entry__.py): `entry()`,
one FixedUpdate tick of the dense GBP swarm planner, ready to call, and
`dryrun_multichip(n)`, the robot-sharded tick over n ranks on tiny shapes.
"""

from __future__ import annotations

import torch


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): `fn(state, sdf)` runs one `tick.step` of an
    8-robot circle (float32, 4 internal + 2 external GBP slots) on `device`,
    the card unless the caller asks for the CPU; on the card the slots run
    through the hand-written kernels."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.sim.builder import build_scenario, circle_formation

    specs = circle_formation(8, circle_radius=25.0, target_speed=10.0)
    params, state, sdf = build_scenario(
        specs, target_speed=10.0, planning_horizon=2.0,
        comms_radius=50.0, internal=4, external=2, dtype=torch.float32,
        device=device,
    )

    def fn(state, sdf):
        return T.step(state, sdf, params)

    return fn, (state, sdf)


def _dryrun_rank(rank: int, n: int, device_type: str) -> None:
    """One rank of `dryrun_multichip` (run by parallel/launch.py:spawn_ranks
    inside the process group)."""
    from dataclasses import replace

    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.parallel.comm import ShardComm
    from magics_tpu_torch.parallel.shard_tick import gather_state, make_shard_step, shard_state
    from magics_tpu_torch.sim.builder import build_scenario, circle_formation

    device = (torch.device("cuda", rank % torch.cuda.device_count()) if device_type == "cuda"
              else torch.device("cpu"))
    n_robots = -(-max(2 * n, 8) // n) * n
    specs = circle_formation(n_robots, circle_radius=20.0, target_speed=8.0)
    params, state, sdf = build_scenario(
        specs, target_speed=8.0, planning_horizon=1.0,
        comms_radius=60.0, internal=2, external=2, n_slots=4,
        dtype=torch.float32, device=device,
    )
    comm = ShardComm.of_group(n_robots)

    # path 1: the one-process tick, two steps (where the JAX dry run runs
    # GSPMD, which has no counterpart here: parallel/shard_tick.py)
    ref = T.run_ticks(state, sdf, params, 2)
    if not bool(torch.isfinite(ref.pos).all()):
        raise AssertionError("non-finite positions after the one-process steps")

    # paths 2 and 3: the sharded tick with explicit collectives, under the
    # reference's exchange and the production multi-chip one
    for exchange, tol in (("sender", 1e-5), ("receiver_compact", 1e-4)):
        fn = make_shard_step(replace(params, ext_exchange=exchange), n_robots, n_ticks=2,
                             comm=comm)
        out = gather_state(fn(shard_state(state, rank, n), sdf), comm)
        if not bool(torch.isfinite(out.pos).all()):
            raise AssertionError(f"non-finite positions ({exchange}, sharded)")
        if not torch.allclose(out.pos, ref.pos, rtol=tol, atol=tol):
            err = float((out.pos - ref.pos).abs().max())
            raise AssertionError(
                f"the sharded {exchange} tick disagrees with the one-process tick: "
                f"max |d pos| {err:.3g} > {tol:g}"
            )


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     backend: str | None = None, timeout: float = 300.0) -> None:
    """Run the tick over `n_devices` robot-sharded ranks on tiny shapes (the
    counterpart of __graft_entry__.py:dryrun_multichip): n fresh processes
    in one process group, each holding R / n robots, run the one-process
    tick, then the `ShardComm` tick under "sender" and "receiver_compact",
    and hold the sharded positions to the one-process ones within 1e-5 and
    1e-4, as the JAX dry run does. On the card unless the caller asks for
    the CPU (without a card it raises); `backend` nccl (one card per rank;
    too few cards raise) unless asked for gloo, which the CPU always takes.
    Raises if any rank fails."""
    from magics_tpu_torch.graph.state import require_device
    from magics_tpu_torch.parallel.launch import spawn_ranks

    device = require_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError(f"the CPU takes the gloo backend, not {backend}")
    spawn_ranks(_dryrun_rank, n_devices, (device.type,), backend=backend, timeout=timeout)

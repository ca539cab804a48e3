"""Entry point of the port (counterpart of __graft_entry__.py's `entry()`):
one FixedUpdate tick of the dense GBP swarm planner, ready to call.

The multi-GPU dry run (`dryrun_multichip`) waits for the port's sharded
tick (ROADMAP Queue 1).
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

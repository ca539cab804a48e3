"""Write the JAX package's trajectory of the 4-robot crossing, for the card
test that holds the port's kernel path against it (the card has no JAX).

    python scripts/torch_crossing_reference.py [OUT]   # default tests/data/torch_crossing_jax.npz

The crossing is tests/test_pallas_slot.py:test_multi_tick_trajectories_agree's:
four robots on a 22 m circle with staggered radii crossing at 10 m/s,
horizon 3 s, 6 internal + 3 external slots a tick, K=4, float32. It runs 20
ticks of the JAX package's XLA path (`use_pallas=False`, its default; that
test holds the Pallas path within 2.0 m of it) on the CPU and writes `pos`,
the positions [21, 4, 2] at ticks 0..20. `crossing(builder)` builds the
same scenario with either package's sim/builder.py, so this module imports
JAX only inside `jax_positions`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

TICKS = 20
REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "tests" / "data" / "torch_crossing_jax.npz"


def crossing(builder, dtype, **extra):
    """(params, state, sdf) of the crossing, built by `builder` (magics_tpu's
    or magics_tpu_torch's sim.builder module) with `dtype` and `extra`
    arguments of its build_scenario."""
    specs = builder.circle_formation(4, circle_radius=22.0, target_speed=10.0)
    for i, s in enumerate(specs):
        shift = 1.0 + 0.15 * i
        s.start[:2] *= shift
        s.waypoints[0, :2] *= shift
    return builder.build_scenario(
        specs, target_speed=10.0, planning_horizon=3.0, hz=10.0,
        comms_radius=60.0, internal=6, external=3, n_slots=4,
        world=(100.0, 100.0), dtype=dtype, **extra,
    )


def jax_positions() -> np.ndarray:
    """[TICKS + 1, 4, 2] positions of the JAX package's float32 run, on the
    CPU with float64 enabled (as the repo's tests run JAX)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from magics_tpu.graph import tick as T
    from magics_tpu.sim import builder as B

    params, state, sdf = crossing(B, jnp.float32)
    step = jax.jit(T.step, static_argnums=2)
    out = [np.asarray(state.pos)]
    for _ in range(TICKS):
        state = step(state, sdf, params)
        out.append(np.asarray(state.pos))
    return np.stack(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0]) if argv else DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, pos=jax_positions())
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Write the numpy oracle's trajectories of the parity cases, for the port's
parity harness (magics_tpu_torch/scripts/parity_rmse.py), which runs where
there is no JAX and so cannot run tests/oracle.py (its 4x4 Schur step and
belief inverse are the JAX package's jitted functions).

    python scripts/torch_oracle_reference.py [OUT]   # default tests/data/torch_oracle_parity.npz

The cases are scripts/parity_rmse.py's but the cluttered one, which reads
the reference's scenario files (not in the repo). Each runs through
tests/compare_util.build_pair as that script runs it: horizon 3 s, comms
250 m, 10 + 10 slots, K = R-1, no despawn, float64, on the CPU. Written per
case: `{case}_pos` [T, R, 2], the oracle's positions after each of its T
ticks (80 for every case); `{case}_completed` [T, R], its
completion flags after each tick; and for the record `{case}_jax_rmse`
[2], the JAX dense tick's max-over-robots position RMSE against the oracle
over those ticks, in float64 and then in float32 (the same initial state
cast, the same params with dtype float32).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "tests" / "data" / "torch_oracle_parity.npz"
NO_TRK = ("dynamic", "obstacle", "interrobot")
# case -> (ticks, factors). scripts/parity_rmse.py runs lanes 80 ticks and
# the crossings 60 at its default --ticks; the port's harness runs the
# circle 80 (60 ends inside its finishing window: the oracle has 2 of 8
# robots done at tick 55, 8 at 60). Every case holds 80, so junction can be
# checked at any --ticks up to 80
CASES = {
    "lanes": (80, NO_TRK),
    "circle": (80, NO_TRK),
    "junction": (80, ("dynamic", "obstacle", "tracking", "interrobot")),
}


def pair(name: str):
    """(params, state, sdf, oracle) of a case, as scripts/parity_rmse.py's
    run_case builds them."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from scripts import parity_rmse as P
    from tests.compare_util import build_pair

    starts, wpls, radii, speed = getattr(P, f"{name}_case")()
    R = len(starts)
    return build_pair(
        starts=starts, waypoint_lists=wpls, radii=radii, speed=speed, horizon_s=3.0,
        comms_radius=250.0, internal=10, external=10, n_slots=R - 1, despawn=False,
        factors=CASES[name][1],
    )


def oracle_run(name: str, ticks: int | None = None):
    """The oracle's positions [T, R, 2] and completion flags [T, R] after
    each of the case's first `ticks` ticks (all of them when None)."""
    _, _, _, oracle = pair(name)
    R = oracle.R
    pos, done = [], []
    for _ in range(CASES[name][0] if ticks is None else ticks):
        oracle.step()
        if not all(len(oracle.connected[r]) == R - 1 for r in range(R)):
            raise AssertionError(f"{name}: the oracle's degree fell below {R - 1}")
        pos.append(np.array(oracle.pos, dtype=np.float64))
        done.append(np.array(oracle.completed, dtype=bool))
    return np.stack(pos), np.stack(done)


def jax_rmse(name: str, oracle_pos: np.ndarray, dtype) -> float:
    """The JAX dense tick's max-over-robots position RMSE against the
    oracle's positions, in `dtype`."""
    import jax
    import jax.numpy as jnp

    from magics_tpu.graph import tick as T

    params, state, sdf, _ = pair(name)
    if dtype != jnp.float64:
        params = dataclasses.replace(params, dtype=dtype)
        state = jax.tree.map(
            lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x, state)
        sdf = sdf.astype(dtype)
    step = jax.jit(T.step, static_argnums=2)
    sq = np.zeros(oracle_pos.shape[1])
    for want in oracle_pos:
        state = step(state, sdf, params)
        sq += np.sum((np.asarray(state.pos, dtype=np.float64) - want) ** 2, axis=1)
    return float(np.sqrt(sq / len(oracle_pos)).max())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    out = Path(argv[0]) if argv else DEFAULT_OUT
    arrays = {}
    for name in CASES:
        pos, done = oracle_run(name)
        rmse = [jax_rmse(name, pos, dtype) for dtype in (jnp.float64, jnp.float32)]
        arrays[f"{name}_pos"] = pos
        arrays[f"{name}_completed"] = done
        arrays[f"{name}_jax_rmse"] = np.array(rmse)
        print(f"{name}: {len(pos)} ticks, oracle completed {int(done[-1].sum())}/"
              f"{done.shape[1]}; JAX RMSE float64 {rmse[0]:.3e} m, float32 {rmse[1]:.3e} m")
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

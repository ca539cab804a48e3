"""The fused internal GBP slot (K1) alone (counterpart of the JAX package's
bench/profile_slot.py).

Times a chain of N dependent internal slots (each one's outputs feed the
next, as in the schedule) through the kernel, `kernels.gbp_slot.
internal_slot`, against the same chain through its plain version
(`internal_slot_fused_reference`), on R robots of the JAX tool's circle:

    python -m magics_tpu_torch.bench.profile_slot [R] [N] [--platform cuda|cpu]

The JAX tool times its slot kernel with the obstacle taps that XLA
gathers beside it, and without them (zero taps). The port's K1 samples the
SDF itself, so the second line here is K1 over an SDF of all ones (taps
that cost the same loads and change nothing), the first K1 over a field of
obstacles. The JAX tool's r_tile sweep has no counterpart: the kernel
chooses its own robot tile. On the card each chain is timed by CUDA events
after a warm chain; on the CPU the wrapper runs the plain version, and the
lines are the CPU's times on the host clock.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from magics_tpu_torch.bench.profile_tick import chunk_ms


def obstacle_sdf(n: int = 128) -> np.ndarray:
    """A smooth periodic field of obstacles in [0, 1], quantised to 1/255 as
    env.sdf quantises a rendered environment."""
    y, x = np.mgrid[0:n, 0:n] / n
    field = 0.5 + 0.5 * np.sin(2 * np.pi * 5 * x) * np.cos(2 * np.pi * 3 * y + 1.0)
    return np.round(field * 255.0) / 255.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("robots", nargs="?", type=int, default=1024)
    p.add_argument("slots", nargs="?", type=int, default=50)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda asked for, but torch.cuda.is_available() is false; "
                         "pass --platform cpu to run on the CPU")

    from magics_tpu_torch.kernels.gbp_slot import internal_slot, internal_slot_fused_reference
    from magics_tpu_torch.kernels.hot import _ext_sum_hot, slot_params, to_hot
    from magics_tpu_torch.sim.builder import build_scenario, circle_formation

    R, N = args.robots, args.slots
    speed = 15.0
    params, state, _ = build_scenario(
        circle_formation(R, circle_radius=200.0, target_speed=speed), target_speed=speed,
        planning_horizon=5.0, hz=10.0, comms_radius=50.0, internal=1, external=0,
        n_slots=8, world=(500.0, 500.0), sdf=np.ones((128, 128)), dtype=torch.float32,
        device=args.platform,
    )
    device = state.device
    sp = slot_params(params)
    world = (params.world_width, params.world_height)
    f = state.prior_mean.dtype
    h0 = to_hot(state, params)
    ext_eta, ext_lam = _ext_sum_hot(state)
    fixed = {"gate": torch.ones((1, R), dtype=f, device=device),
             "tgate": torch.ones((1, R), dtype=f, device=device),
             "ext_sum_eta": ext_eta, "ext_sum_lam": ext_lam}
    sdfs = {"obstacle SDF": torch.as_tensor(obstacle_sdf(), dtype=f, device=device),
            "SDF all ones": torch.ones((128, 128), dtype=f, device=device)}

    def chain(slot, sdf):
        def run():
            h = dict(h0)
            for _ in range(N):
                h = {**h, **slot({**h, **fixed}, sdf, world, sp)}
            return h["belief_mean"]
        return run

    where = (f"{torch.cuda.get_device_name(device)}, CUDA events" if device.type == "cuda"
             else "cpu, host clock: the plain version")
    print(f"# R={R}, a chain of {N} internal slots; {where}", flush=True)
    lines = [("K1 chain, " + k, internal_slot, s) for k, s in sdfs.items()]
    lines.append(("plain chain, obstacle SDF", internal_slot_fused_reference,
                  sdfs["obstacle SDF"]))
    for name, slot, sdf in lines:
        ms = chunk_ms(chain(slot, sdf), 3, device)
        print(f"{name:34s} {ms / N:8.4f} ms/slot  ({ms:8.2f} ms total)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Completion spread of the parity harness's chaotic cases across roundoff
variants of the port's tick, on the CPU.

The circle and junction crossings amplify roundoff into divergence, so
which tick each robot finishes on depends on the summation order. This
script runs each case of magics_tpu_torch/scripts/parity_rmse.py under
eight variants of the port's dense tick (float64 and float32; the sender
and receiver_compact exchanges; the plain passes and the kernels' hot-layout
path, whose wrappers run their plain versions on the CPU) and prints, per
case and variant, the robots done at tick 60 and each robot's completion
tick beside the numpy oracle's committed one
(tests/data/torch_oracle_parity.npz), and the largest distance of any robot
from the oracle's over the first 10 to 50 ticks. The cases are deterministic: no seed
enters them. It sets parity_rmse.COMPLETION_WINDOW_TICKS.

    python scripts/torch_parity_spread.py [--json OUT]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from magics_tpu_torch.scripts import parity_rmse as P  # noqa: E402

REFERENCE = Path(__file__).resolve().parents[1] / "tests" / "data" / "torch_oracle_parity.npz"
TICKS = 80
AT = 60
EARLY = (10, 20, 30, 40, 50)


def variants():
    for dtype, exchange, use_pallas in itertools.product(
            (torch.float64, torch.float32), ("sender", "receiver_compact"), (False, True)):
        yield f"{str(dtype)[6:]} {exchange} {'kernels' if use_pallas else 'plain'}", \
            dtype, exchange, use_pallas


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    reference = P.load_reference(REFERENCE)
    out = {}
    for name in ("circle", "junction"):
        make, factors, _, _ = P.CASES[name]
        ref_ticks = P.completion_ticks(reference[f"{name}_completed"][:TICKS])
        out[name] = {"oracle": {"done_at_60": int(reference[f"{name}_completed"][AT - 1].sum()),
                                "completion_ticks": ref_ticks}}
        print(f"{name}: oracle done at tick {AT} "
              f"{out[name]['oracle']['done_at_60']}, completion ticks {ref_ticks}")
        for label, dtype, exchange, use_pallas in variants():
            params, state, sdf = P.build_case(*make(), factors=factors, dtype=dtype,
                                              device="cpu", use_pallas=use_pallas)
            params = dataclasses.replace(params, ext_exchange=exchange)
            run = P.trajectory(params, state, sdf, TICKS)
            ticks = P.completion_ticks(run["completed"])
            shift = [None if a is None or b is None else a - b for a, b in zip(ticks, ref_ticks)]
            worst = max((abs(s) for s in shift if s is not None), default=None)
            err = np.linalg.norm(run["pos"] - reference[f"{name}_pos"][:TICKS], axis=-1).max(1)
            early = {t: float(err[:t].max()) for t in EARLY}
            out[name][label] = {"done_at_60": int(run["completed"][AT - 1].sum()),
                                "completion_ticks": ticks, "shift": shift, "max_shift": worst,
                                "max_divergence_m_to_tick": early}
            print(f"  {label}: done at tick {AT} {out[name][label]['done_at_60']}, completion "
                  f"ticks {ticks}, shift from the oracle's {shift}, widest {worst}; max "
                  f"divergence to tick " + ", ".join(f"{t} {e:.2e} m" for t, e in early.items()))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

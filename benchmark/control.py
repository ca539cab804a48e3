"""The lower-precision control of a cell's comparison, and the program's
own readings beside it, over many seeds in one process (set-up, the kernel
builds above all, is paid once).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5

For each seed it runs the cell's driver with a short window, then the
check twice: the program's output against the reference (the lower
reading), and the reference computed with TF32 products in the program's
place against the reference (the control, the upper reading), each judged
under the cell's limits as a run is judged. One JSON line a seed: the
numbers compared and `correct` for each side; the control's has to read
false. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)

    from benchmark import harness as H

    cell = H.cell(args.workload)
    run = H.driver(cell.traffic["driver"]).run
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = H.Context(cell, seed, args.seconds, False, control=True)
        out = run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "attempted": out.attempted, "failed": out.failed,
                          "correct": H.correct(out.checks),
                          "checks": {c.name: c.value for c in out.checks},
                          "control_correct": H.correct(out.control),
                          "control": {c.name: c.value for c in out.control},
                          "limits": {c.name: c.limit for c in out.checks},
                          **out.end_to_end}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

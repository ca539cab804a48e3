"""The benchmark of magics_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's workloads: its configuration file
(benchmark/configs/), its traffic file (benchmark/traffic/<traffic>.json,
which names its loop, benchmark/drivers/<kind>.py) and its own data
file (benchmark/workloads/<cell>.json: the check's parameters and limits).
The loop builds the program's inputs from the configuration and the
seed, warms up, measures for --seconds, and checks what the timed path
produced against the plain reference (benchmark/reference/). With --trace 0
the result line holds the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, each read by benchmark/metrics/<metric>.py.

The last line of standard output is the result, one JSON object; the last
lines of standard error each number compared beside its limit. Without a
card, or with fewer than the cell asks for, the run exits 2 and prints no
result; if JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cache = ROOT / "benchmark" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"

    from benchmark import harness as H

    cell = H.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        H.log(f"{args.workload} needs {cell.chips} CUDA card(s): "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}")
        return 2
    torch.cuda.set_device(0)
    H.log(f"[run] {args.workload} seed {args.seed} on {H.card()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    ctx = H.Context(cell, args.seed, args.seconds, bool(args.trace))
    out = H.driver(cell.traffic["driver"]).run(ctx)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = H.reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = ctx.setup_s if m["name"] == "setup_s" else out.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = H.device_info(torch, cell.chips, ctx.memory_peak)
    breakdown = None
    window = out.traces.get("window")
    if args.trace and window is not None:
        device["busy_s"] = window.busy_s()
        device["window_s"] = window.window_s
        breakdown = {"device_ops": H.device_ops(window),
                     "idle_gaps": H.idle_gaps(window, ctx.spans)}
    # after every reader and every call into the program, just before the
    # result: whatever this process loaded is in sys.modules by now
    found = H.forbidden_modules()
    if found:
        H.log(f"forbidden modules loaded in this process: {', '.join(found)}")
        return 3
    for note in out.notes:
        print(json.dumps(note), flush=True)
    H.print_checks(out.checks)
    print(H.result_line(out, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

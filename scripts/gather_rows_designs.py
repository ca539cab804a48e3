"""Time the row gather's designs on one NVIDIA GPU, alone and inside the
bench ticks:

    python scripts/gather_rows_designs.py [--parent DIR] [--part alone|ticks] [--json OUT]

The designs: the kernel of magics_tpu_torch/kernels/csrc/layout.cu
("repo": a thread a word, evict-first stores only for an output larger
than 32 MB), the alternatives of scripts/gather_rows_designs.cu (that file
says what each does; "/plain" and "/evict" name their stores, whatever the
size) and, with --parent, the layout.cu of another checkout ("parent").
All are built with kernels/build.py's nvcc flags.

1. Alone: each design at chip_smoke.py's four call-site shapes (its
   `gather_sites` on the sender bench state after 3 ticks), checked bit for
   bit against `index_select` (+ the mask), device us per launch in
   repeated calls and with L2 flushed before each (torch.profiler), beside
   `index_select`'s own device time.
2. In the ticks: the bench workload under "sender", "receiver_compact" and
   "receiver", after 2 warm-up chunks of 20 ticks. For each design in turn,
   then again in reverse order, the wrapper's kernel (`layout._GATHER`) is
   swapped for the design's: 2 ticks to settle, a 2-tick torch.profiler
   window (the gather's device us per launch and launches per tick, device
   ms per tick), then 10 ticks on the host clock ending in
   torch.cuda.synchronize() (ms per tick).

Both parts run unless --part names one; each takes some 200 torch.profiler
windows, and one process for each part keeps the profiler's sessions per
process down. Prints a line per measurement and the card's name and power
limit, and with --json writes every reading to that file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

#: alternative design: (design, stores) of gather_rows_designs.cu
ALTERNATIVES = {
    "thread a word/evict": (0, 1),
    "thread a word/plain": (0, 0),
    "lane groups/plain": (1, 0),
    "lane groups/evict": (1, 1),
    "flat runs/plain": (2, 0),
    "flat runs/evict": (2, 1),
}
EXCHANGES = ("sender", "receiver_compact", "receiver")


def build(parent: Path | None) -> dict:
    """Build the designs, one nvcc each, all at once; returns {name:
    function(table, idx, mask, out, n_out, row_bytes, stream) -> rc}."""
    from magics_tpu_torch.kernels import build as B
    from magics_tpu_torch.kernels import layout as L

    out_dir = B.BUILD_DIR / "designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"designs": HERE / "scripts" / "gather_rows_designs.cu"}
    if parent is not None:
        sources["parent"] = parent / "magics_tpu_torch" / "kernels" / "csrc" / "layout.cu"
    jobs = {name: subprocess.Popen([B.nvcc_path(), *B.NVCC_FLAGS, "-o",
                                    str(out_dir / f"lib{name}.so"), str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in sources.items()}
    L._lib()
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = {"repo": L._GATHER}
    for name, proc in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{report}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        if name == "parent":
            lib.gather_rows.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
            fns["parent"] = lib.gather_rows
            continue
        fn = lib.gather_rows_design
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        for alt, (design, evict) in ALTERNATIVES.items():
            fns[alt] = (lambda t, i, m, o, n, rb, s, _d=design, _e=evict:
                        fn(t, i, m, o, n, rb, _d, _e, s))
    return fns


def alone(torch, fns: dict, order: list) -> dict:
    import chip_smoke as CS
    from magics_tpu_torch.bench.headline import bench_scenario
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import layout as L
    from magics_tpu_torch.profiling import call_device_us, kernel_device_us

    params, state, sdf = bench_scenario("sender")
    state = T.run_ticks(state, sdf, params, 3)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for site, (tab, idx, m) in CS.gather_sites(torch, state).items():
        want = L.gather_rows_reference(tab, idx, m)
        lw, lc, _ = call_device_us(lambda: tab.index_select(0, idx))
        print(f"[alone] {site}: index_select warm {lw:.3f} cold {lc:.3f} us", flush=True)
        res[site] = {"index_select": [lw, lc]}
        args = (tab.data_ptr(), idx.data_ptr(), None if m is None else m.data_ptr())
        n, row = idx.shape[0], tab.shape[1] * tab.element_size()
        for name in order + order[::-1]:
            out = torch.full_like(want, float("nan"))

            def call(fn=fns[name], out=out):
                rc = fn(*args, out.data_ptr(), n, row, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            same = torch.equal(out, want)
            if not same:
                raise AssertionError(f"{name} at {site}: not bit-equal to index_select")
            warm = kernel_device_us(call, "gather_rows")
            cold = kernel_device_us(call, "gather_rows", cold=True)
            print(f"[alone] {site}: {name}: bit-equal, warm {warm:.3f} cold {cold:.3f} us",
                  flush=True)
            res[site].setdefault(name, []).append([warm, cold])
    return res


def in_ticks(torch, fns: dict, order: list) -> dict:
    import chip_smoke as CS
    from magics_tpu_torch.bench.headline import bench_scenario
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import layout as L
    from magics_tpu_torch.profiling import profile

    res = {}
    for exchange in EXCHANGES:
        params, state, sdf = bench_scenario(exchange)
        for _ in range(2):
            state = T.run_ticks(state, sdf, params, CS.CHUNK)
        res[exchange] = {}
        try:
            for name in order + order[::-1]:
                L._GATHER = fns[name]
                state = T.run_ticks(state, sdf, params, 2)
                p = profile(lambda: T.run_ticks(state, sdf, params, 2))
                hits = [v for key, v in p["kernels"].items() if "gather_rows" in key]
                launches = sum(n for n, _ in hits)
                us = sum(t for _, t in hits) / max(1, launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state = T.run_ticks(state, sdf, params, 10)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / 10
                print(f"[ticks] {exchange}: {name}: gather {us:.3f} us per launch, "
                      f"{launches / 2:.1f} a tick; device {p['device_us'] / 2e3:.3f} ms per tick; "
                      f"{ms:.3f} ms per tick", flush=True)
                res[exchange].setdefault(name, []).append(
                    [us, launches / 2, p["device_us"] / 2e3, ms])
        finally:
            L._GATHER = fns["repo"]
        del state
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout, whose layout.cu is timed too")
    ap.add_argument("--part", choices=("alone", "ticks"), help="run only this part")
    ap.add_argument("--json", type=Path, help="write every reading to this file")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.cuda.set_device(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    fns = build(a.parent.resolve() if a.parent else None)
    order = ["repo", *(["parent"] if a.parent else []), *ALTERNATIVES]
    res = {"card": card, "order": order}
    if a.part in (None, "alone"):
        res["alone"] = alone(torch, fns, order)
    if a.part in (None, "ticks"):
        res["ticks"] = in_ticks(torch, fns, order)
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

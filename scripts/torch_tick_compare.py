"""Compare checkouts of the PyTorch port (magics_tpu_torch) on one NVIDIA GPU,
one process per checkout, in the order given:

    python scripts/torch_tick_compare.py [--json OUT.json] PARENT_DIR . . PARENT_DIR

For each checkout, the bench.py workload built by that checkout's port on
the card, with its kernels, under "sender" and then "receiver_compact",
driven as chip_smoke.py drives its slices: the scenario from
`magics_tpu_torch.bench.headline.bench_scenario` of this checkout, built by
each checkout's builder (asked for the card and the kernels, which an older
checkout does not default to) and the timing from
`chip_smoke.time_slice` (ms per tick over 3 timed chunks of 20 ticks after 2
warm-up chunks; cudaLaunchKernel calls, device time per tick and each
kernel's device time per launch from a 2-tick torch.profiler window). Under
"sender" it adds the internal-slot, variable-slot and row-gather wrappers'
host time per call over 10 ticks (no synchronisation, so their host work alone) and 10
ticks with synchronised host timers around each phase of the hot loop
(graph/gbp.py and the exchange's steps, graph/exchange.py; ms per tick). Last, the variable-slot kernel and the row gather alone on
chip_smoke.py's inputs, in repeated calls and with L2 flushed before each
(`kernels_alone`).

Prints one `RESULT {json}` line per checkout and a summary, and with
`--json` writes them all to that file. chip_smoke.py and the profiler
helpers (magics_tpu_torch/profiling.py, which imports only torch) come from
the checkout holding this script, loaded by path, so every checkout is
driven by the same code and an older one needs neither.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# K2's chain lengths on both sides of its smallest tile's limit: 2 robots a
# block up to V = 277, 1 from 278 (csrc/gbp_slot.cu)
LONG_CHAINS = (277, 278)
KERNELS = ("internal_slot_kernel", "variable_slot_kernel", "interrobot_slot_kernel",
           "gather_rows_kernel")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import magics_tpu_torch
    from magics_tpu_torch.graph import factors as F
    from magics_tpu_torch.graph import exchange as EX
    from magics_tpu_torch.graph import gbp as GBP
    from magics_tpu_torch.graph import tick as T

    if Path(magics_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise RuntimeError(f"imported {magics_tpu_torch.__file__}, not the checkout {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    prof = _load("port_profiling", HERE / "magics_tpu_torch" / "profiling.py")
    smoke = _load("chip_smoke_here", HERE / "chip_smoke.py")
    bench = _load("port_headline", HERE / "magics_tpu_torch" / "bench" / "headline.py")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"tree": str(tree), "card": smi.splitlines()[0], "torch": torch.__version__}

    for exchange in ("sender", "receiver_compact"):
        params, state, sdf = bench.bench_scenario(exchange, device="cuda", use_pallas=True)
        run = smoke.time_slice(torch, params, state, sdf, prof.profile)
        state, p = run["state"], run["profile"]
        res = {"ms_per_tick": 1e3 * run["seconds"] / run["ticks"]}
        res["launches_per_tick"] = p["launches"] / 2
        res["device_ms_per_tick"] = p["device_us"] / 2e3
        res["kernel_us_per_launch"] = {
            k: sum(us for name, (n, us) in p["kernels"].items() if k in name)
            / max(1, sum(n for name, (n, us) in p["kernels"].items() if k in name))
            for k in KERNELS
        }
        if exchange == "sender":
            rec, restore = prof.host_timers([(GBP, "internal_slot"), (GBP, "variable_slot"),
                                             (EX, "gather_rows")], sync=False)
            state = T.run_ticks(state, sdf, params, 10)
            torch.cuda.synchronize()
            restore()
            for name, (calls, secs) in rec.items():
                res[f"{name}_wrapper_host_ms_per_call"] = 1e3 * secs / calls
            ex = EX.exchange_of(params)
            phases = [(F, "obstacle_taps"), (GBP, "internal_slot"), (GBP, "variable_slot"),
                      (GBP, "external_factor_pass"), (GBP, "_ext_sum_hot"),
                      (ex, "seed_cavities"), (ex, "deliver_responses"),
                      (T, "update_connectivity")]
            rec, restore = prof.host_timers(phases, sync=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = T.run_ticks(state, sdf, params, 10)
            torch.cuda.synchronize()
            res["tick_ms_with_phase_timers"] = 1e3 * (time.perf_counter() - t0) / 10
            restore()
            res["phase_ms_per_tick"] = {n: [c / 10, 1e3 * s / 10] for n, (c, s) in rec.items()}
        out[exchange] = res
    out["kernels_alone"] = kernels_alone(torch, smoke, bench, prof)
    return out


def longer_chain(var_in: dict, sp, V: int):
    """The variable slot's inputs and SlotParams on a chain of V variables,
    each variable and factor taking the data of its place modulo the
    original chain (as tests/test_torch_kernels_cuda.py makes them)."""
    import numpy as np
    import torch

    V0 = sp.n_vars
    at = {V0: np.arange(V) % V0,   # by plane length: variables, dynamic, interior factors
          V0 - 1: np.minimum(np.arange(V - 1) % V0, V0 - 2),
          V0 - 2: np.clip((np.arange(V - 2) + 1) % V0 - 1, 0, V0 - 3)}
    out = {}
    for name, x in var_in.items():
        if name != "gate":
            idx = torch.as_tensor(at[x.shape[-2]], device=x.device)
            x = x.index_select(x.ndim - 2, idx).contiguous()
        out[name] = x
    return out, replace(sp, n_vars=V)


def kernels_alone(torch, smoke, bench, prof) -> dict:
    """The checkout's variable-slot kernel and row gather called alone on
    chip_smoke.py's inputs (K2's from the receiver_compact bench state after
    3 ticks, also on that chain made LONG_CHAINS variables long; the
    gather's four call sites from the sender's): device us per launch [in
    repeated calls, with L2 flushed before each]."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import gbp_slot as G
    from magics_tpu_torch.kernels import hot as HOT
    from magics_tpu_torch.kernels import layout as L

    def us(fn, kernel):
        return [prof.kernel_device_us(fn, kernel), prof.kernel_device_us(fn, kernel, cold=True)]

    res = {}
    for exchange in ("receiver_compact", "sender"):
        params, state, sdf = bench.bench_scenario(exchange, device="cuda", use_pallas=True)
        state = T.run_ticks(state, sdf, params, 3)
        if exchange == "receiver_compact":
            slot_in = smoke.slot_inputs(state, params)
            var_in = {n: slot_in[n] for n in G._VAR_IN_FIELDS}
            sp = HOT.slot_params(params)
            res["variable_slot"] = us(lambda: G.variable_slot(var_in, sp), "variable_slot_kernel")
            for V in LONG_CHAINS:
                var_v, sp_v = longer_chain(var_in, sp, V)
                res[f"variable_slot V={V}"] = us(lambda: G.variable_slot(var_v, sp_v),
                                                 "variable_slot_kernel")
                del var_v
        else:
            for site, (tab, idx, m) in smoke.gather_sites(torch, state).items():
                res[f"gather_rows {site}"] = us(lambda: L.gather_rows(tab, idx, m),
                                                "gather_rows_kernel")
    return res


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(measure(Path(sys.argv[2]))), flush=True)
        return 0
    args = sys.argv[1:]
    out = None
    if args[:1] == ["--json"]:
        out, args = Path(args[1]), args[2:]
    results = []
    for tree in args:
        # absolute, as the child runs in this script's checkout
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(tree).resolve())],
                              capture_output=True, text=True, cwd=HERE)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", flush=True)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        results.append(json.loads(lines[0][len("RESULT "):]))
        print(lines[0], flush=True)
    for r in results:
        s, rc = r["sender"], r["receiver_compact"]
        print(f"{r['tree']}: sender {s['ms_per_tick']:.3f} ms/tick, "
              f"{s['launches_per_tick']:.1f} launches/tick, device {s['device_ms_per_tick']:.3f} "
              f"ms/tick, K1 wrapper {s['internal_slot_wrapper_host_ms_per_call']:.4f} ms/call, "
              f"K2 wrapper {s['variable_slot_wrapper_host_ms_per_call']:.4f} ms/call, "
              f"K4 wrapper {s['gather_rows_wrapper_host_ms_per_call']:.4f} ms/call; "
              f"receiver_compact {rc['ms_per_tick']:.3f} ms/tick, "
              f"{rc['launches_per_tick']:.1f} launches/tick ({r['card']})", flush=True)
        print(f"{r['tree']}: alone, device us per launch repeated / L2 flushed: "
              + "; ".join(f"{k} {w:.3f} / {c:.3f}" for k, (w, c) in r["kernels_alone"].items()),
              flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch + CUDA port (magics_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc.
2. Build: compiles the three kernel libraries from csrc/ at once
   (kernels/build.py) and prints their ptxas lines.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the bench shapes (R=1024, K=32, V=21, W=2, float32). The slot kernels on
   the hot dict of the bench scenario after a few ticks: the internal slot,
   which samples the SDF itself, against its fused plain version (the SDF
   taps, then the JAX-shaped reference) on a non-trivial SDF with a third of
   the obstacle linearisation points on pixel edges, tracking on and off;
   the variable slot. The inter-robot message table on a sender-mode bench
   state after 3 ticks with some cavities unseeded and the peers' positions
   moved into range. The row gather, bit for bit, at its four call sites'
   shapes. Prints errors, flips, CUDA-event times of both, each kernel's
   device time per launch (torch.profiler; for the variable slot, the
   message table and the row gather also with L2 flushed before each
   launch) and its bound, and for the row gather `index_select`'s call and
   device times on the same inputs.
4. Small input: 20 ticks of a converging 16-robot crossing through the
   kernels against the port's plain GBP passes (asked for with
   use_pallas=False) on the card, for each of the three exchanges.
5. The slices: the bench.py workload (R=1024, 50 internal + 10 external
   slots per tick), built with the defaults (on the card, kernels on),
   through `tick.run_ticks`, first with the "sender" exchange, then with
   "receiver_compact": 2 warm-up chunks of 20 ticks, then 3 timed chunks
   each; asserts finite state, motion, no neighbour overflow, live
   connectivity and the exact kernel launches per tick; prints a metric
   line in bench.py's format for each, then cudaLaunchKernel calls and
   device time per tick from a 2-tick profile. After the sender slice, the
   message table against its plain version once more, on the slice's own
   final state (live factors, some cavities unseeded).

6. Graph vs eager: after each slice, 10-tick chunks of its workload
   captured as one CUDA graph (graph/chunk.py:compile_ticks) from the
   slice's final state: the capture's launch counts (10 x the per-tick
   ones), 2 replays bit-equal to 20 eager ticks in every state field, then
   3 timed chunks (host clock, CUDA events over a replay, torch.profiler of
   one replay where it records the graph's kernels) and a metric line with
   "runner": "graph" (phase 5's carries "runner": "eager").
7. Grid vs dense: 20 eager ticks of the bench workload with the grid on
   (cell 50 m, capacity 32, 8 partners) bit-equal to the dense path in
   every shared field, grid_overflow 0, under "sender" and
   "receiver_compact".
8. The scale slice: magics_tpu_torch/bench/scale.py's workload at
   R=16384 (K=24, 10 internal + 10 external CENTERED, grid), under
   "receiver_compact" and then "sender", through compile_ticks: capture
   seconds, 1 warm and 3 timed chunks of 10 ticks; asserts finite state,
   motion, no overflow, live connectivity, the capture's launches per tick
   (10 / 10 / 10 / 20 and 10 / 10 / 0 / 10) and 10 eager ticks bit-equal
   to one replay; prints scale.py's line, a metric line, the state's bytes
   and the peak memory, each kernel's launches per tick (the capture's
   count), its device us per launch (torch.profiler of one replay where it
   records the kernel, else of one eager tick, named in `device_us_of`)
   and its bound at these shapes, one eager tick's time by phase, and
   checks each kernel against its plain version at these shapes.
9. The Simulator shell (sim/simulator.py), on scenarios built in memory
   (TOML text, formation dicts, builtin or empty environments; no file, no
   YAML): (a) the Circle Experiment, 50 robots (K=49, V=21, 50 + 10 slots)
   through `Simulator.run` in 100-tick CUDA graphs, to the contract of
   tests/test_scenario_behavior.py (every robot completes, makespan < 60 s,
   no neighbour overflow), then export and analysis (finite LDJ and
   distance, mean distance >= 100 m), with the capture's launches per tick,
   the graphs alive (at most two) and the host ms of a diagnostics sample
   and of the log harvest; (b) one tick of its state mid-crossing with the
   kernels against the plain passes, each kernel against its plain version
   at these shapes and K3 / K4 at K=128, and each kernel's device time per
   launch there; (c) reset() against a fresh Simulator, and a checkpoint at
   tick 100 resumed in a fresh Simulator bit-equal to the uninterrupted run
   at tick 150; (d) comms failure at 0.7: one seed twice (and after reset())
   bit-equal, another seed different, the failed share 0.7 +- 0.05;
   (e) in-flight rrt-star missions on the builtin intersection, every one
   done, the planner backend and the loads of the state into the graphs;
   (f) 1024 robots for 100 ticks through `Simulator.run` against phase 6's
   sender graph: the shell's overhead per tick.
10. The user's surfaces, over scenario directories written into a temporary
   directory (config.toml as save_settings writes it, environment.yaml and
   formation.yaml as JSON documents, which need no PyYAML): (a) the Circle
   Experiment of 9(a) and the ring of 9(f); (b) `cli.main` in this process
   with --export --snapshot --player --checkpoint: every robot completes,
   the export bit-equal to 9(a)'s, launches a tick 50 / 10 / 10 / 20 (the
   counts set to 0 just before and read just after), the PNG's pixels
   render_trajectories' array, the player embedding the export, and the
   host ms of each output; (c) the REPL in a subprocess, float64 (the plain
   passes on the card): step 3, step 3, run 1, status, set, `load` the
   ring, step 5, then --export: ticks exact, the export the ring's, the
   dtype kept, no graph captured for a step size; (d) a LiveServer on port
   0 over the ring, `drive` on a thread at 5-tick chunks, and over HTTP
   pause, step 3, a set, resume and quit after 100 ticks: frames arrive,
   one harvest, one capture; drive's ms/tick against `run` at 100-tick
   chunks.
11. The sharded path (parallel/): (a) two processes of `python -m
   magics_tpu_torch.parallel.launch --backend gloo` sharing one card (NCCL
   takes a card per rank), each with R_SCALE / 2 robots of the scale workload,
   5 eager ticks under "sender" and then "receiver_compact": each rank
   asserts its kernel launches a tick (10 / 10 / 10 / 20 and 10 / 10 / 0 /
   10) and prints its ms/tick, its collective bytes a tick by call site
   beside the exchange's traffic model (which must match exactly) and its
   kernels' device us per launch (rank 0's torch.profiler); the ranks agree
   on a checksum, and rank 0's gathered state is held to 5 one-process
   eager ticks from the same start (discrete fields exact, float fields
   bit-equal or within SHARD_RTOL, printed); (b) `dryrun_multichip(2)` over
   gloo on the card; (c) (a) again over nccl, one card per rank, where the
   machine has two cards, else the line `nccl: not run (1 card)`.
12. Experiments and parity (magics_tpu_torch/scripts/): (a) the parity
   harness's cases against the numpy oracle's committed trajectories
   (tests/data/torch_oracle_parity.npz): lanes through the kernels in
   float32, 80 ticks, max-over-robots RMSE within 3e-3 m (ROADMAP F13),
   completion equal, the degree held at 5; lanes in float64 (the plain
   passes) within PARITY_F64_RMSE; circle (80 ticks) and junction (60)
   through the kernels, completion within +-1 and each robot's completion
   tick within the harness's window of the oracle's; each kernel run's
   launches a tick from the counters, then K1-K4 each against its plain
   version at the case's shapes; (b) `run_experiment.main` in this process
   over the Circle Experiment's directory: 10 and 50 robots, seeds 0 and
   31, max time 60 s, each row to the experiment's contract (every robot
   completes, makespan < 60 s, no overflow) at 50 / 10 / 10 / 20 launches
   a tick, K1-K4 each against its plain version at a 10-robot row's
   shapes, the 50-robot seed-0 row's export bit-equal to a direct
   `Simulator` run, capture and replay seconds, export and analysis ms per
   row; then 10 robots at comms failure 0.0 and 0.7, the 0.7 row's
   failed-antenna share within 0.05.

The last two lines are a JSON object of per-kernel results and the JSON
status line `{"ok": true, "device": {...}}`. Nothing here imports JAX. The
script refuses to run without a CUDA device; no check is caught.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

R_BENCH = 1024
CHUNK = 20
GRAPH_CHUNK = 10
R_SCALE = 16384
SOURCE = {
    "internal_slot": "magics_tpu_torch/kernels/csrc/gbp_slot.cu",
    "variable_slot": "magics_tpu_torch/kernels/csrc/gbp_slot.cu",
    "interrobot_slot": "magics_tpu_torch/kernels/csrc/ir_slot.cu",
    "gather_rows": "magics_tpu_torch/kernels/csrc/layout.cu",
}
REPLACES = {
    "internal_slot": "magics_tpu/kernels/gbp_slot.py:838",
    "variable_slot": "magics_tpu/kernels/gbp_slot.py:802",
    "interrobot_slot": "magics_tpu/kernels/ir_slot.py:121",
    "gather_rows": "magics_tpu/kernels/layout.py:31",
}
# Kernel launches per tick of the bench workload (50 internal + 10 external
# slots). Under "sender" each external slot makes one message table, one
# delivery gather of the peers' outboxes and one response gather; under
# "receiver_compact" one gather of the peers' compact tables.
LAUNCHES_PER_TICK = {
    "sender": {"internal_slot": 50, "variable_slot": 10, "interrobot_slot": 10,
               "gather_rows": 20},
    "receiver_compact": {"internal_slot": 50, "variable_slot": 10, "interrobot_slot": 0,
                         "gather_rows": 10},
}
# The same for the scale workload (10 internal + 10 external slots).
SCALE_LAUNCHES_PER_TICK = {
    "sender": {"internal_slot": 10, "variable_slot": 10, "interrobot_slot": 10,
               "gather_rows": 20},
    "receiver_compact": {"internal_slot": 10, "variable_slot": 10, "interrobot_slot": 0,
                         "gather_rows": 10},
}
KERNEL_NAMES = {"internal_slot": "internal_slot_kernel", "variable_slot": "variable_slot_kernel",
                "interrobot_slot": "interrobot_slot_kernel", "gather_rows": "gather_rows_kernel"}
# The H100 SXM's published peaks (NVIDIA's data sheet, at its 700 W limit):
# HBM bandwidth and float32 outside the tensor cores. A kernel's bound is the
# larger of its bytes over the first and its operations over the second,
# both what its function needs at the timed run's inputs: each output written
# once, and each input read once where the function reads it at all (the
# passthrough inputs of a gated-on robot, the cavities of factors that give
# an empty message whatever, are not read; see slot_bytes and
# interrobot_bytes).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per work item, counted from the kernels' arithmetic (adds,
# multiplies, divides and square roots alike), for the bounds: the internal
# slot per robot and variable (two dynamic messages of a 4x4 inverse and
# three 4x4 products each, ~1,080 a factor; the belief update's inverse,
# residual product and sums, ~400; obstacle and tracking ~160), the variable
# slot per robot and variable (~400), the message table per factor (a 4x4
# determinant, two columns of the adjugate, 13 divisions, ~250). The row
# gather only moves bytes.
OPS_PER_ITEM = {"internal_slot": 1640, "variable_slot": 400, "interrobot_slot": 250}
# Kernel vs plain version, both float32 on the card: each vector or matrix
# of each field over its own scale, max(|plain| over its components, 1)
# (gbp_slot.scaled_error; a response, belief less incoming message, also
# over the message's scale), so the 1e30-pinned endpoint rows are held to
# their own relative error and set no scale for the interior rows. The two
# sum 4-term products in different orders, so they agree to float32
# roundoff amplified by the 4x4 inverses (measured at most 5.1e-5 at the
# bench shapes on an H100); a wrong term moves an entry by O(its scale).
RTOL = 1e-4
# The belief update's residual guard (||Lam Sigma - I|| < 1e-4) is a knife
# edge: a precision whose last bits differ may land on the other side. At
# most this share of (robot, variable) decisions may differ.
MAX_FLIP_SHARE = 1e-3
# The inter-robot message table's guards (|det| > 1e-6, sane, negligible)
# are knife edges too, but the kernel repeats the plain version's float
# order, so no entry may be zero in one version and not in the other, and
# the rest are held to IR_RTOL of each message's own scale,
# max(|plain| over (gx, gy, t, s), 1). Measured bit-equal (0 of scale) on
# both inputs here and on the card test's ill-conditioned cavities (an
# H100), once the plain version summed w in the kernel's order
# (factors.interrobot_rank1_messages says why).
IR_RTOL = 2e-5
# Kernel path vs the plain passes over 20 ticks of the small crossing, both
# float32 on the card: the largest position difference. Measured 2.4e-2 m
# on an H100; the bound leaves 4x for another card or toolkit, and a wrong
# response or snapshot that feeds the next slots moves it by metres.
SMALL_DRIFT_M = 0.1


def log(*parts) -> None:
    print(*parts, flush=True)


def device_phase(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from magics_tpu_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} | torch.version.cuda {torch.version.cuda} | "
        f"nvcc {release[0].strip() if release else nvcc.stdout.strip()}")


def build_phase() -> None:
    from magics_tpu_torch.kernels import build
    from magics_tpu_torch.kernels import gbp_slot, ir_slot, layout

    t0 = time.perf_counter()
    build.build_all()   # one nvcc per source, all at once
    for module in (gbp_slot, ir_slot, layout):
        module._lib()
    log(f"[build] {', '.join(build.SOURCES)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        log(f"[build] {name}: {build.library_path(name).name}")
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] ptxas {name}: {line.strip()}")


def reset_counts() -> None:
    from magics_tpu_torch.kernels import gbp_slot, ir_slot, layout

    for module in (gbp_slot, ir_slot, layout):
        module.reset_launch_counts()


def read_counts() -> dict:
    from magics_tpu_torch.kernels import gbp_slot, ir_slot, layout

    return {**gbp_slot.launch_counts, **ir_slot.launch_counts, **layout.launch_counts}


def obstacle_sdf(n: int = 128) -> np.ndarray:
    """A non-trivial SDF image in [0, 1]: a smooth periodic field of
    obstacles, quantised to 1/255 like magics_tpu env.sdf.env_to_sdf."""
    y, x = np.mgrid[0:n, 0:n] / n
    field = 0.5 + 0.5 * np.sin(2 * np.pi * 5 * x) * np.cos(2 * np.pi * 3 * y + 1.0)
    return np.round(field * 255.0) / 255.0


def on_pixel_edges(torch, mu, sdf_shape, world, seed: int = 0):
    """obs_v2f_mu [4, V2, R] with every third linearisation point moved onto
    a pixel edge of the SDF (world x = j W_w / W - W_w / 2 rounded to float32,
    and y alike), where the pixel index is a knife edge."""
    H, W = sdf_shape
    ww, wh = world
    g = torch.Generator(device=mu.device).manual_seed(seed)
    j = torch.randint(1, W, mu.shape[1:], generator=g, device=mu.device).double()
    i = torch.randint(1, H, mu.shape[1:], generator=g, device=mu.device).double()
    out = mu.clone()
    out[0, :, ::3] = (j * ww / W - ww / 2.0).float()[:, ::3]
    out[1, :, ::3] = (wh / 2.0 - i * wh / H).float()[:, ::3]
    return out


def tap_flips(torch, got: dict, want: dict) -> int:
    """Obstacle factors whose message differs from the plain version's by
    more than RTOL of its own scale. A flipped SDF pixel index moves the
    message by at least one SDF quantum over the tap step, far past RTOL at
    the check's SDF and world, so this counts tap-index flips (and any other
    fault of the obstacle messages)."""
    from magics_tpu_torch.kernels.gbp_slot import rows

    bad = None
    for field in ("obs_f2v_eta", "obs_f2v_lam"):
        g, w = rows(got[field]).double(), rows(want[field]).double()
        dims = tuple(range(2, g.ndim))
        err = (g - w).abs().amax(dim=dims) / w.abs().amax(dim=dims).clamp(min=1.0)
        bad = err > RTOL if bad is None else bad | (err > RTOL)
    return int(bad.sum())


def bound(nbytes: int, ops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def slot_bytes(torch, h: dict, out: dict, need: dict) -> int:
    """The bytes a slot function (hot-layout fields [c..., P, R]) must move
    at these inputs: each output written once, and each input read once for
    the robots that need it. `need` maps a field to [(robots [R] bool, share
    of a robot's entries)]; besides, every slot reads the gate, a gated-off
    robot's old belief (passed through), a gated-on robot's prior and
    external sum, and the old belief mean where the belief keeps it (gated
    off, or the new one failing its guards)."""
    gate = h["gate"][0] > 0
    every = torch.ones_like(gate)
    need = {
        "gate": [(every, 1)], "belief_eta": [(~gate, 1)], "belief_lam": [(~gate, 1)],
        **{n: [(gate, 1)] for n in ("prior_mean", "prior_sigma", "ext_sum_eta", "ext_sum_lam")},
        **need,
    }
    total = nbytes(out.values())
    for name, parts in need.items():
        x = h[name]
        per_robot = x.numel() // x.shape[-1] * x.element_size()
        total += sum(int(mask.sum()) * per_robot * share for mask, share in parts)
    old_mean = ~gate[:, None] | ~belief_validity(torch, out)
    mean = h["belief_mean"]   # [4, V, R]: a variable's mean is 4 entries
    return int(total) + mean.shape[0] * mean.element_size() * int(old_mean.sum())


def internal_slot_bytes(torch, h: dict, sdf, world, p, out: dict) -> int:
    """slot_bytes of the internal slot. A gated-on robot computes its
    dynamic and obstacle messages (the latter from the x, y of its
    linearisation points) and, where `tgate`, its tracking ones, so the old
    ones are not read; a disabled factor's are. The tracking records and
    last measurements count for every robot (a measured factor does not
    need them; off on the main path). The SDF counts the distinct pixels
    that the live obstacle factors' taps read."""
    from magics_tpu_torch.graph import factors as F

    gate, tgate = h["gate"][0] > 0, h["tgate"][0] > 0
    every = torch.ones_like(gate)
    dyn, obs = gate & p.dynamic_enabled, gate & p.obstacle_enabled
    trk = tgate & p.tracking_enabled
    trk_kept = ~(gate & p.tracking_enabled)   # the old tracking v2f mean passes through
    need = {
        "tgate": [(every if p.tracking_enabled else ~every, 1)],
        "delta_t": [(dyn, 1)], "dyn_v2f_eta": [(every, 1)], "dyn_v2f_lam": [(every, 1)],
        "dyn_v2f_mu": [(~dyn, 1)], "dyn_f2v_eta": [(~dyn, 1)], "dyn_f2v_lam": [(~dyn, 1)],
        "obs_v2f_mu": [(obs, 0.5), (~obs, 1)],
        "obs_f2v_eta": [(~obs, 1)], "obs_f2v_lam": [(~obs, 1)],
        "trk_v2f_mu": [(trk | trk_kept, 1)],
        "trk_f2v_eta": [(~trk, 1)], "trk_f2v_lam": [(~trk, 1)],
        **{n: [(every, 1)] for n in ("trk_record", "trk_timeout", "trk_last_pos",
                                     "trk_last_val")},
        **{n: [(trk, 1)] for n in ("path_x", "path_y", "path_len")},
    }
    # obstacle_taps samples 1 - image: on an image of -(pixel number) each
    # tap inside the image gives its pixel's number + 1, outside 0
    ids = -torch.arange(1, sdf.numel() + 1, device=sdf.device, dtype=torch.float32)
    mu = h["obs_v2f_mu"].movedim(0, -1)[:, obs]
    taps = torch.stack(F.obstacle_taps(mu, ids.view(sdf.shape), world))
    pixels = int(taps[taps > 0].unique().numel())
    return slot_bytes(torch, h, out, need) + sdf.element_size() * pixels


def variable_slot_bytes(torch, h: dict, out: dict) -> int:
    """slot_bytes of the variable slot: a gated-on robot sums every factor
    message to each variable."""
    gate = h["gate"][0] > 0
    return slot_bytes(torch, h, out, {
        n: [(gate, 1)] for n in ("dyn_f2v_eta", "dyn_f2v_lam", "obs_f2v_eta", "obs_f2v_lam",
                                 "trk_f2v_eta", "trk_f2v_lam")})


def interrobot_bytes(inputs: dict, live, out) -> int:
    """The bytes the message table must move at these inputs, `live` [R, K,
    V1] marking the seeded factors within the safety distance: every slot's
    seeded flag; the peer position of a seeded slot (an unseeded one gives
    an empty message whatever); the own position (x, y) of a chain position
    with a seeded slot, its cavity (eta, precision) where one is live; the
    safety distance of a robot with a seeded slot, its id where one is live;
    every message written once."""
    seeded = inputs["seeded"]
    return (seeded.numel() + 8 * int(seeded.sum()) + 8 * int(seeded.any(dim=1).sum())
            + 80 * int(live.any(dim=1).sum()) + 4 * int(seeded.flatten(1).any(dim=1).sum())
            + 4 * int(live.flatten(1).any(dim=1).sum()) + nbytes([out]))


def timed(torch, name: str, kernel, plain, kernel_name: str, nb: int, ops: float,
          library=None, cold: bool = False) -> dict:
    """CUDA-event times per call of the wrapper and of the plain version (and
    of one library call, where there is one), the kernel's device time per
    launch by torch.profiler in repeated calls (`device_us_warm`) and, with
    `cold`, with its inputs evicted from L2 before each launch
    (`device_us_cold`), and its bound. `device_us` is the time the main
    path's caller sees: cold where `cold` says the caller finds the inputs
    cold, else warm."""
    from magics_tpu_torch.profiling import kernel_device_us

    warm = kernel_device_us(kernel, kernel_name)
    out = {"ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
           "library_ms": cuda_ms(torch, library) if library is not None else None,
           "device_us_warm": warm,
           "device_us_cold": kernel_device_us(kernel, kernel_name, cold=True) if cold else None,
           **bound(nb, ops)}
    out["device_us"] = out["device_us_cold"] if cold else warm
    log(f"[kernels] {name}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms"
        + (f", library {out['library_ms']:.4f} ms" if library is not None else "")
        + f" (CUDA events, median of 20); device {warm:.3f} us per launch repeated"
        + (f", {out['device_us_cold']:.3f} us with L2 flushed before each" if cold else "")
        + f" (torch.profiler) against a bound of {1e3 * out['bound_ms']:.3f} us "
        f"({nb / 1e6:.2f} MB, {ops / 1e9:.4f} GOP; {out['bound_by']})")
    return out


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Median over `reps` of one call's device time, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, got: dict, want: dict, max_flips: float) -> float:
    """Field-by-field check of kernel outputs against the plain version.
    Returns the largest absolute belief_mean error; raises past RTOL or past
    `max_flips` validity-mask flips."""
    from magics_tpu_torch.kernels.gbp_slot import scaled_error

    rel = {}
    for field, w in want.items():
        g = got[field]
        if g.dtype == torch.int32:
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {field} differs ({int((g != w).sum())} entries)")
            rel[field] = 0.0
            continue
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: {field} has non-finite values")
        rel[field] = scaled_error(field, g, want)
    flips = int((belief_validity(torch, got) != belief_validity(torch, want)).sum())
    abs_err = float((got["belief_mean"] - want["belief_mean"]).abs().max())
    worst = max(rel, key=rel.get)
    log(f"[kernels] {name}: max |err| belief_mean {abs_err:.3e} m, worst field "
        f"{worst} {rel[worst]:.3e} of scale, validity-mask flips {flips} "
        f"of {got['belief_mean'][0].numel()}")
    log(f"[kernels] {name}: error over own scale per field: "
        + (", ".join(f"{f} {e:.1e}" for f, e in rel.items() if e > 0.0) or "all 0"))
    bad = {f: e for f, e in rel.items() if e > RTOL}
    if bad or flips > max_flips:
        raise AssertionError(f"{name}: fields past rtol {RTOL}: {bad}; flips {flips}")
    return abs_err


def belief_validity(torch, out: dict):
    """[R, V] guard decision of the belief update ("precision not zero" and
    the residual-checked inverse), recomputed from a version's own output
    precision by the same plain function for both versions."""
    from magics_tpu_torch.core.linalg import belief_covariance
    from magics_tpu_torch.kernels.gbp_slot import rows

    lam = rows(out["belief_lam"])
    _, ok = belief_covariance(lam)
    return (lam > 1e-6).any(dim=-1).any(dim=-1) & ok


def slot_inputs(state, params) -> dict:
    """The slot kernels' inputs from a bench state, as the hot loop gives
    them: the hot layout, every active robot gated on, the external sums."""
    from magics_tpu_torch.kernels import hot as HOT

    h = HOT.to_hot(state, params)
    gate = (state.active & (state.mission_active | state.completed)).float()[None].contiguous()
    ext = HOT._ext_sum_hot(state)
    return {**h, "gate": gate, "tgate": gate, "ext_sum_eta": ext[0], "ext_sum_lam": ext[1]}


def gather_sites(torch, state) -> dict:
    """The row gather's four call sites at the bench shapes, {site: (table,
    idx, mask)}: the state's own indexes and masks, seeded random tables."""
    R, K = state.nbr_idx.shape
    V1 = state.snap_mu.shape[1] - 1
    src = state.nbr_idx.clamp(0, R - 1).long()
    back = state.nbr_back.clamp(0, K - 1).long()
    mask = state.nbr_mask.reshape(-1)
    g = torch.Generator(device=state.device).manual_seed(1)

    def table(n, m):
        return torch.randn((n, m), generator=g, device=state.device)

    return {
        "sender delivery": (table(R * K, V1 * 4), (src * K + back).reshape(-1), mask),
        "sender response": (table(R, V1 * 2), src.reshape(-1), mask),
        "receiver pack": (table(R, V1 * 24), src.reshape(-1), None),
        "receiver_compact table": (table(R, V1 * 8), src.reshape(-1), None),
    }


def kernel_phase(torch, device) -> dict:
    from dataclasses import replace

    from magics_tpu_torch.bench.headline import bench_scenario
    from magics_tpu_torch.graph import factors as F
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import gbp_slot as G
    from magics_tpu_torch.kernels import hot as HOT

    params, state, sdf = bench_scenario()
    state = T.run_ticks(state, sdf, params, 3)
    world = (params.world_width, params.world_height)
    sdf_obs = torch.as_tensor(obstacle_sdf(), device=device, dtype=torch.float32)
    sp = replace(
        HOT.slot_params(params),
        obstacle_delta=F.obstacle_delta(tuple(sdf_obs.shape), world),
    )
    slot_in = slot_inputs(state, params)
    obs_mu = on_pixel_edges(torch, slot_in["obs_v2f_mu"], sdf_obs.shape, world)
    slot_in["obs_v2f_mu"] = obs_mu
    gate = slot_in["gate"]
    taps = F.obstacle_taps(obs_mu.movedim(0, -1), sdf_obs, world)
    n_obs = taps[0].numel()
    log(f"[kernels] bench hot dict after 3 ticks: R={state.n_robots} V={params.n_vars} "
        f"W={params.max_waypoints}; SDF taps with a gradient: "
        f"{float((taps[1] != taps[0]).float().mean()):.1%}, on pixel edges: "
        f"{obs_mu[0, :, ::3].numel()} of {n_obs} obstacle factors")

    results = {}
    errs = []
    for trk in (True, False):
        spt = replace(sp, tracking_enabled=trk)
        got = G.internal_slot(slot_in, sdf_obs, world, spt)
        want = G.internal_slot_fused_reference(slot_in, sdf_obs, world, spt)
        torch.cuda.synchronize()
        label = f"internal_slot tracking={'on' if trk else 'off'}"
        errs.append(compare(torch, label, got, want, max_flips=0))
        flips = tap_flips(torch, got, want)
        log(f"[kernels] {label}: tap-index flips {flips} of {n_obs} obstacle factors")
        if flips:
            raise AssertionError(f"{label}: {flips} obstacle messages off (tap-index flips)")
    # timing at the main path's flags and SDF (the bench's own)
    n_gated = int((gate > 0).sum())
    want = G.internal_slot_fused_reference(slot_in, sdf, world, sp)
    results["internal_slot"] = {
        "max_abs_err": max(errs),
        **timed(torch, f"internal_slot (bench flags and SDF; {n_gated} robots gated on)",
                lambda: G.internal_slot(slot_in, sdf, world, sp),
                lambda: G.internal_slot_fused_reference(slot_in, sdf, world, sp),
                "internal_slot_kernel", internal_slot_bytes(torch, slot_in, sdf, world, sp, want),
                OPS_PER_ITEM["internal_slot"] * n_gated * params.n_vars),
    }

    var_in = {name: slot_in[name] for name in G._VAR_IN_FIELDS}
    got = G.variable_slot(var_in, sp)
    want = G.variable_slot_reference(var_in, sp)
    torch.cuda.synchronize()
    err = compare(torch, "variable_slot", got, want,
                  max_flips=MAX_FLIP_SHARE * got["belief_mean"][0].numel())
    # on the main path K2 reads the f2v messages K1 wrote slots before, and
    # the external pass's traffic runs through L2 in between: it finds its
    # inputs cold, and its headline time is taken so
    results["variable_slot"] = {
        "max_abs_err": err,
        **timed(torch, "variable_slot", lambda: G.variable_slot(var_in, sp),
                lambda: G.variable_slot_reference(var_in, sp), "variable_slot_kernel",
                variable_slot_bytes(torch, var_in, want),
                OPS_PER_ITEM["variable_slot"] * n_gated * params.n_vars, cold=True),
    }

    params, state, sdf = bench_scenario("sender")
    state = T.run_ticks(state, sdf, params, 3)
    results["interrobot_slot"] = interrobot_check(torch, state, params, "synthetic")
    results["gather_rows"] = gather_check(torch, state)
    return results


def interrobot_compare(torch, inputs: dict, sigma: float, label: str) -> tuple:
    """The inter-robot message table against its plain version on `inputs`
    (ir_slot.sender_inputs): finite, no entry zero in one and not the other,
    each live message within IR_RTOL of its own scale, some message live.
    Returns the kernel's table and the largest absolute error."""
    from magics_tpu_torch.kernels import ir_slot as IR

    R, K, V1 = inputs["seeded"].shape
    got = IR.interrobot_slot(**inputs, sigma=sigma)
    want = IR.interrobot_slot_reference(**inputs, sigma=sigma)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("interrobot_slot: non-finite messages")
    live_got, live_want = (got != 0).any(dim=-1), (want != 0).any(dim=-1)
    flips = int((live_got != live_want).sum())
    both = live_got & live_want
    scale = want.abs().amax(dim=-1).clamp(min=1.0)
    rel = float(((got - want).abs().amax(dim=-1) / scale)[both].max()) if bool(both.any()) else 0.0
    abs_err = float((got - want).abs()[both].max()) if bool(both.any()) else 0.0
    n = live_want.numel()
    log(f"[kernels] interrobot_slot {label} R={R} K={K} V1={V1}: {int(live_want.sum())} live "
        f"messages of {n} ({int((~inputs['seeded']).sum())} cavities unseeded); error over own "
        f"scale {rel:.3e}, max |err| {abs_err:.3e}; zero-pattern flips {flips} of {n}")
    if not bool(live_want.any()) or rel > IR_RTOL or flips:
        raise AssertionError(f"interrobot_slot {label}: rel {rel} (rtol {IR_RTOL}), "
                             f"flips {flips}")
    return got, abs_err


def interrobot_check(torch, state, params, label: str) -> dict:
    """The inter-robot message table against its plain version on a
    sender-mode bench state, and its times. With label "synthetic" (the
    state after 3 ticks, when no pair of the bench ring, 4.9 m apart, is
    within the 4.4 m safety distance yet) the seeded flags of every third
    robot are cleared on every other variable (tests/test_ir_slot.py), so
    the empty-cavity guard runs, and each external position is moved to a
    seeded random point within 1.2 safety distances of its internal
    snapshot, so the live path, the skip and the guards all run on many
    entries; otherwise the state's own inputs are taken as the main path
    gives them."""
    from magics_tpu_torch.kernels import ir_slot as IR

    inputs = IR.sender_inputs(state, params)
    R, K, V1 = inputs["seeded"].shape
    seeded = inputs["seeded"]
    if label == "synthetic":
        seeded = seeded.clone()
        seeded[::3, :, ::2] = False
        inputs["seeded"] = seeded
        g = torch.Generator(device=state.device).manual_seed(0)
        dist = 1.2 * inputs["safety"][:, None, None] * torch.rand(
            (R, K, V1), generator=g, device=state.device)
        angle = 2 * np.pi * torch.rand((R, K, V1), generator=g, device=state.device)
        offset = torch.stack([dist * torch.cos(angle), dist * torch.sin(angle)], dim=-1)
        inputs["p_ext"] = (state.snap_mu[:, None, 1:, :2] + offset).contiguous()
    sigma = params.sigma_factor_interrobot
    got, abs_err = interrobot_compare(torch, inputs, sigma, label)
    # the kernel does the arithmetic only for seeded factors within the
    # safety distance (the others are empty whatever it gives), so the
    # bound counts the bytes and operations of this input's live factors. On
    # the main path its inputs were written slots before, past 24 MB of K1
    # traffic per internal slot: it finds them cold, and is timed so
    x = torch.where(seeded[..., None], inputs["snap_mu"][:, None, 1:, :2], 0.0) - inputs["p_ext"]
    safety2 = (inputs["safety"] * inputs["safety"])[:, None, None]
    live = seeded & ((x * x).sum(dim=-1) < safety2)
    n_work = int(live.sum())
    return {"max_abs_err": abs_err,
            **timed(torch, f"interrobot_slot {label} ({n_work} factors in range and seeded)",
                    lambda: IR.interrobot_slot(**inputs, sigma=sigma),
                    lambda: IR.interrobot_slot_reference(**inputs, sigma=sigma),
                    "interrobot_slot_kernel", interrobot_bytes(inputs, live, got),
                    OPS_PER_ITEM["interrobot_slot"] * n_work, cold=True)}


def gather_check(torch, state) -> dict:
    """The row gather against `index_select`, bit for bit, at its call
    sites' bench shapes, with the state's own indexes and masks and seeded
    random tables: the sender's delivery of the peers' outboxes [R*K, V1*4],
    its response gather of the peers' positions [R, V1*2], the receiver's
    gather of the peers' snapshot packs [R, V1*24] and receiver_compact's
    gather of the peers' compact tables [R, V1*8]. Each shape is timed in
    repeated calls and with L2 flushed before each, beside `index_select`'s
    own device time (torch.profiler) and call time (CUDA events) on the same
    inputs. Returns the delivery's results (the main path's largest) with
    every shape's under "shapes"."""
    from magics_tpu_torch.kernels import layout as L
    from magics_tpu_torch.profiling import call_device_us

    shapes = {}
    for site, (tab, idx, m) in gather_sites(torch, state).items():
        got = L.gather_rows(tab, idx, m)
        want = L.gather_rows_reference(tab, idx, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows {site}: {int((got != want).sum())} entries differ")
        log(f"[kernels] gather_rows {site} [{tab.shape[0]}, {tab.shape[1]}] -> "
            f"[{idx.shape[0]}, {tab.shape[1]}] {'masked' if m is not None else 'unmasked'}: "
            f"bit-equal")
        # bytes: the distinct rows read (of the live entries where masked;
        # a row gathered twice is read once), the rows written, the index
        # and the mask
        read = idx if m is None else idx[m]
        row = tab.shape[1] * tab.element_size()
        nb = int(read.unique().numel()) * row + nbytes([got, idx]) + (
            nbytes([m]) if m is not None else 0)
        library = lambda: tab.index_select(0, idx)   # noqa: E731
        t = timed(torch, f"gather_rows {site}", lambda: L.gather_rows(tab, idx, m),
                  lambda: L.gather_rows_reference(tab, idx, m), "gather_rows_kernel", nb, 0.0,
                  library=library, cold=True)
        # the main path reads its tables warm (the delivery what K3 wrote just
        # before), so the headline is the repeated calls' time; the cold one
        # is kept beside it
        t["device_us"] = t["device_us_warm"]
        t["library_device_us"], t["library_device_us_cold"], names = call_device_us(library)
        log(f"[kernels] gather_rows {site}: index_select device {t['library_device_us']:.3f} us "
            f"per call repeated, {t['library_device_us_cold']:.3f} us with L2 flushed "
            f"(torch.profiler; {'; '.join(n[:80] for n in names)})"
            + (" -- index_select alone, without the mask: less work than the gather"
               if m is not None else ""))
        shapes[site] = t
    return {"max_abs_err": 0.0, **shapes["sender delivery"],
            "shapes": {site: {k: v for k, v in t.items() if k != "bound_by"}
                       for site, t in shapes.items()}}


def small_input_phase(torch, device) -> None:
    """The kernel path against the port's plain GBP passes, 20 ticks of a
    converging crossing with live inter-robot factors (the tests' scenario),
    for each inter-robot exchange."""
    from dataclasses import replace

    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

    specs = circle_formation(16, circle_radius=20.0, target_speed=15.0)
    for i, s in enumerate(specs):  # break the circle's exact distance ties
        s.start[:2] *= 1.0 + 0.01 * i
        s.waypoints[0, :2] *= 1.0 + 0.01 * i
    for exchange in ("receiver_compact", "sender", "receiver"):
        params, state, sdf = build_scenario(
            specs, target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
            internal=6, external=3, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
            world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=torch.float32,
            device=device, despawn_on_final_waypoint=False, tracking_enabled=False,
            ext_exchange=exchange,
        )
        kern = T.run_ticks(state, sdf, params, 20)   # the default on the card: kernels
        plain = T.run_ticks(state, sdf, replace(params, use_pallas=False), 20)
        drift = float((plain.pos - kern.pos).abs().max())
        moved = float((kern.pos - state.pos).abs().max())
        inbox = float(kern.ext_inbox.abs().sum())
        log(f"[small] {exchange}, R=16, 20 ticks: kernel vs plain passes max |dpos| "
            f"{drift:.3e} m; moved {moved:.2f} m; |ext_inbox| {inbox:.3e}")
        if not (drift < SMALL_DRIFT_M and moved > 1.0 and inbox > 0.0):
            raise AssertionError(
                f"{exchange}: kernel path does not track the plain path on the small input")


def time_slice(torch, params, state, sdf, profile) -> dict:
    """Drive a built slice as chip_smoke.py and scripts/torch_tick_compare.py
    time it: 2 warm-up chunks of CHUNK ticks (the swarm reaches steady
    state), the launch counts set to 0, 3 timed chunks (host clock, ending in
    torch.cuda.synchronize()), then a 2-tick window of `profile`
    (magics_tpu_torch/profiling.py). Returns the final state, the warm-up's
    and the timed chunks' seconds, their ticks, the launch counts of the
    timed chunks and the profile."""
    from magics_tpu_torch.graph import tick as T

    t0 = time.perf_counter()
    for _ in range(2):
        state = T.run_ticks(state, sdf, params, CHUNK)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reps = 3
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = T.run_ticks(state, sdf, params, CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    prof = profile(lambda: T.run_ticks(state, sdf, params, 2))
    return {"state": state, "warm_s": warm_s, "seconds": seconds, "ticks": reps * CHUNK,
            "launches": launches, "profile": prof}


def slice_phase(torch, exchange: str) -> dict:
    from magics_tpu_torch.bench.headline import bench_scenario
    from magics_tpu_torch.profiling import profile

    params, state, sdf = bench_scenario(exchange)
    if state.device.type != "cuda" or not params.uses_kernels(state.device):
        raise AssertionError(f"the default-built bench scenario is on {state.device}, "
                             f"use_pallas={params.use_pallas}")
    start_pos = state.pos.clone()
    run = time_slice(torch, params, state, sdf, profile)
    state, dt, ticks, launches = run["state"], run["seconds"], run["ticks"], run["launches"]
    log(f"[slice] {exchange}: warm-up 2 x {CHUNK} ticks in {run['warm_s']:.2f} s")
    guards = check_state(torch, f"slice {exchange}", state, start_pos)
    expected = {name: n * ticks for name, n in LAUNCHES_PER_TICK[exchange].items()}
    if launches != expected:
        raise AssertionError(f"{exchange}: launches {launches} for {ticks} ticks, "
                             f"expected {expected}")

    line = metric_line(params, exchange, state.n_robots, guards["mean_degree"],
                       guards["nbr_overflow"], ticks / dt, "eager")
    live = int((state.ext_inbox != 0).any(dim=-1).sum())
    log(f"[slice] {exchange}: {ticks} ticks in {dt:.3f} s: {1e3 * dt / ticks:.3f} ms/tick; "
        f"moved {guards['moved']:.1f} m; live inbox messages at the end {live}; "
        f"launches {launches}")
    log(json.dumps(line))
    prof = run["profile"]
    log(f"[slice] {exchange}: 2-tick profile: {prof['launches'] / 2:.1f} cudaLaunchKernel and "
        f"{prof['device_us'] / 2e3:.3f} ms of device time per tick (torch.profiler)")
    return launches, state, params, sdf, 1e3 * dt / ticks


def metric_line(params, exchange: str, R: int, mean_degree: float, overflow: int,
                ticks_per_s: float, runner: str) -> dict:
    """bench.py's metric line (bench.headline.metric_line: its keys and
    unit string) with the exchange and the runner beside it."""
    from magics_tpu_torch.bench.headline import metric_line as headline_line

    return {**headline_line(params, R, mean_degree, overflow, ticks_per_s),
            "ext_exchange": exchange, "runner": runner}


def bits_equal(torch, a, b) -> bool:
    """Bit for bit (NaN included), as bytes."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def differing_fields(torch, a, b, skip=()) -> list:
    return [name for name, x in vars(a).items()
            if name not in skip and not bits_equal(torch, x, getattr(b, name))]


def check_state(torch, label: str, state, start_pos) -> dict:
    """The validity guards of a run: finite state, motion, no overflow,
    live connectivity. Returns the guards' numbers."""
    for name, x in vars(state).items():
        if x.is_floating_point() and name not in ("pos_log", "vel_log") and not bool(
                torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite values in {name}")
    out = {"moved": float((state.pos - start_pos).abs().max()),
           "nbr_overflow": int(state.nbr_overflow), "grid_overflow": int(state.grid_overflow),
           "mean_degree": float(state.nbr_mask.sum()) / state.n_robots}
    if out["moved"] <= 1.0 or out["nbr_overflow"] or out["grid_overflow"] or (
            out["mean_degree"] <= 0.0):
        raise AssertionError(f"{label}: guards broken: {out}")
    return out


def time_replays(torch, graph, reps: int) -> dict:
    """`reps` replays: host seconds of each (ending in a synchronise) and
    the CUDA-event milliseconds of each on the stream."""
    host, events = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        events.append(start.elapsed_time(end))
    return {"host_s": host, "event_ms": events}


def graph_phase(torch, exchange: str, state, params, sdf, eager_ms: float) -> float:
    """A slice's workload from its final state as 10-tick CUDA graphs: the
    capture's launch counts, 2 replays bit-equal to 20 eager ticks, 3 timed
    chunks, the graph's device time in one profiled replay, a metric line.
    Returns the graph's ms per tick (host clock)."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.graph.chunk import compile_ticks
    from magics_tpu_torch.profiling import profile

    reset_counts()
    t0 = time.perf_counter()
    graph = compile_ticks(state, sdf, params, GRAPH_CHUNK)
    capture_s = time.perf_counter() - t0
    expected = {k: n * GRAPH_CHUNK for k, n in LAUNCHES_PER_TICK[exchange].items()}
    if graph.launches != expected:
        raise AssertionError(f"graph {exchange}: capture launches {graph.launches}, "
                             f"expected {expected}")
    eager = T.run_ticks(state, sdf, params, 2 * GRAPH_CHUNK)
    before = read_counts()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"graph {exchange}: a replay counted launches")
    bad = differing_fields(torch, graph.state, eager)
    if bad:
        raise AssertionError(f"graph {exchange}: 2 replays differ from 20 eager ticks in {bad}")
    log(f"[graph] {exchange}: captured {GRAPH_CHUNK} ticks in {capture_s:.2f} s (warm-up "
        f"chunk included), {graph.launches} kernel launches a chunk; 2 replays bit-equal to "
        f"20 eager ticks in all {len(vars(eager))} fields")
    del eager
    reps = 3
    t = time_replays(torch, graph, reps)
    ms = 1e3 * sum(t["host_s"]) / (reps * GRAPH_CHUNK)
    event_ms = statistics.median(t["event_ms"]) / GRAPH_CHUNK
    prof = profile(graph.replay, required=False)
    dev_ms = None if prof is None else prof["device_us"] / GRAPH_CHUNK / 1e3
    final = graph.state
    guards = check_state(torch, f"graph {exchange}", final, state.pos)
    if prof is None:
        recorded = ("not recorded (torch.profiler showed no kernel of the replay); busy share "
                    "not recorded")
    else:
        kernels = sum(n for n, _ in prof["kernels"].values()) / GRAPH_CHUNK
        recorded = (f"{dev_ms:.3f} ms (torch.profiler of one replay, {kernels:.0f} kernels a "
                    f"tick); busy share {dev_ms / ms:.1%}")
    log(f"[graph] {exchange}: {reps} chunks of {GRAPH_CHUNK} ticks: {ms:.3f} ms/tick (host "
        f"clock; the eager slice {eager_ms:.3f}), {event_ms:.3f} ms/tick by CUDA events over "
        f"a replay (median of {reps}); device time per tick {recorded}")
    log(json.dumps(metric_line(params, exchange, state.n_robots, guards["mean_degree"],
                               guards["nbr_overflow"], 1e3 / ms, "graph")))
    return ms


def grid_dense_phase(torch) -> None:
    """20 eager ticks of the bench workload on the grid path against the
    dense path: every shared field bit-equal, grid_overflow 0."""
    from magics_tpu_torch.bench.headline import bench_scenario
    from magics_tpu_torch.graph import tick as T

    for exchange in ("sender", "receiver_compact"):
        pd, sd, sdf = bench_scenario(exchange)
        pg, sg, _ = bench_scenario(exchange, grid_cell_size=50.0, grid_capacity=32,
                                   collision_partners=8)
        sd = T.run_ticks(sd, sdf, pd, 20)
        sg = T.run_ticks(sg, sdf, pg, 20)
        bad = differing_fields(torch, sd, sg, skip=("rr_overlap", "rr_partner"))
        if bad or int(sg.grid_overflow) != 0:
            raise AssertionError(f"grid vs dense {exchange}: fields differ {bad}, "
                                 f"grid_overflow {int(sg.grid_overflow)}")
        log(f"[grid] {exchange}: 20 ticks at R={R_BENCH}, grid (cell 50 m, capacity 32, "
            f"8 partners) bit-equal to dense in every shared field; grid_overflow 0, "
            f"mean degree {float(sg.nbr_mask.sum()) / R_BENCH:.2f}, rr_collisions "
            f"{int(sg.rr_collisions)}")


def scale_bounds(torch, state, params, sdf, exchange: str) -> dict:
    """Each kernel's bound at the scale shapes, at the state's own inputs
    (slot_bytes and friends, as the bench-shape checks count them), and
    each kernel against its plain version there: K1 and K2 to RTOL of each
    vector's or matrix's scale, K3 (sender) on the synthetic variant of
    its inputs (the ring's 4.9 m spacing leaves no factor in range yet), K4
    bit for bit at this exchange's call sites."""
    from magics_tpu_torch.kernels import gbp_slot as G
    from magics_tpu_torch.kernels import hot as HOT
    from magics_tpu_torch.kernels import ir_slot as IR
    from magics_tpu_torch.kernels import layout as L

    sp = HOT.slot_params(params)
    world = (params.world_width, params.world_height)
    h = slot_inputs(state, params)
    n_gated = int((h["gate"] > 0).sum())
    want = G.internal_slot_fused_reference(h, sdf, world, sp)
    compare(torch, f"internal_slot R={state.n_robots}", G.internal_slot(h, sdf, world, sp), want,
            max_flips=0)
    out = {"internal_slot": bound(internal_slot_bytes(torch, h, sdf, world, sp, want),
                                  OPS_PER_ITEM["internal_slot"] * n_gated * params.n_vars)}
    var_in = {name: h[name] for name in G._VAR_IN_FIELDS}
    want = G.variable_slot_reference(var_in, sp)
    compare(torch, f"variable_slot R={state.n_robots}", G.variable_slot(var_in, sp), want,
            max_flips=MAX_FLIP_SHARE * want["belief_mean"][0].numel())
    out["variable_slot"] = bound(variable_slot_bytes(torch, var_in, want),
                                 OPS_PER_ITEM["variable_slot"] * n_gated * params.n_vars)
    if exchange == "sender":
        # the bound of the main path's own inputs: nothing in range yet
        inputs = IR.sender_inputs(state, params)
        seeded = inputs["seeded"]
        snap = torch.where(seeded[..., None], inputs["snap_mu"][:, None, 1:, :2], 0.0)
        x = snap - inputs["p_ext"]
        live = seeded & ((x * x).sum(dim=-1) < (inputs["safety"] ** 2)[:, None, None])
        msg = IR.interrobot_slot_reference(**inputs, sigma=params.sigma_factor_interrobot)
        out["interrobot_slot"] = bound(interrobot_bytes(inputs, live, msg),
                                       OPS_PER_ITEM["interrobot_slot"] * int(live.sum()))
        interrobot_check(torch, state, params, "synthetic")
    sites = ("sender delivery", "sender response") if exchange == "sender" else (
        "receiver_compact table",)
    nb = []
    for site, (tab, idx, m) in gather_sites(torch, state).items():
        if site not in sites:
            continue
        got = L.gather_rows(tab, idx, m)
        if not torch.equal(got, L.gather_rows_reference(tab, idx, m)):
            raise AssertionError(f"gather_rows {site} R={state.n_robots}: differs from its "
                                 f"plain version")
        read = idx if m is None else idx[m]
        nb.append(int(read.unique().numel()) * tab.shape[1] * tab.element_size()
                  + nbytes([got, idx]) + (nbytes([m]) if m is not None else 0))
        log(f"[scale] gather_rows {site} [{tab.shape[0]}, {tab.shape[1]}] -> "
            f"[{idx.shape[0]}, {tab.shape[1]}]: bit-equal to its plain version; bound "
            f"{1e3 * bound(nb[-1], 0.0)['bound_ms']:.3f} us ({nb[-1] / 1e6:.2f} MB)")
    # per launch: the mean over this exchange's call sites, one launch each
    out["gather_rows"] = bound(sum(nb) // len(nb), 0.0)
    return out


def tick_phases(torch, state, sdf, params) -> dict:
    """Milliseconds of each phase of one eager tick from `state`: the
    functions of tick.step's chain and, within iterate_gbp, the hot loop's
    pieces, each bracketed by synchronisations (host and device work)."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import hot as HOT
    from magics_tpu_torch.profiling import host_timers

    chain = ("activate_due_spawns", "check_waypoints", "update_connectivity",
             "update_connectivity_grid", "update_failed_comms", "update_prior_horizon",
             "update_prior_current", "iterate_gbp", "update_message_counts",
             "update_collisions", "update_collisions_grid", "update_goal_areas",
             "log_positions")
    slot = [(HOT, "internal_slot"), (HOT, "variable_slot"), (HOT, "_ext_sum_hot"),
            (T, "seed_cavities"), (T, "external_factor_pass"), (T, "deliver_responses")]
    rec, restore = host_timers([(T, name) for name in chain] + slot, sync=True)
    try:
        T.step(state, sdf, params)
    finally:
        restore()
    return {name: 1e3 * secs for name, (calls, secs) in rec.items() if calls}


def scale_phase(torch, exchange: str) -> dict:
    """The scale slice at R_SCALE through compile_ticks (see the module
    docstring, phase 8). Returns each kernel's device us per launch,
    launches per tick and bound at these shapes."""
    from magics_tpu_torch.bench import scale as S
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.graph.chunk import clone_state, compile_ticks
    from magics_tpu_torch.profiling import profile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, sdf = S.scale_scenario(R_SCALE, exchange)
    build_s = time.perf_counter() - t0
    state_mb = nbytes(vars(state).values()) / 1e6
    start_pos = state.pos.clone()
    reset_counts()
    t0 = time.perf_counter()
    graph = compile_ticks(state, sdf, params, S.CHUNK)
    capture_s = time.perf_counter() - t0
    per_tick = SCALE_LAUNCHES_PER_TICK[exchange]
    expected = {k: n * S.CHUNK for k, n in per_tick.items()}
    if graph.launches != expected:
        raise AssertionError(f"scale {exchange}: capture launches {graph.launches}, "
                             f"expected {expected}")
    del state
    S.run_chunks(graph, 1)                                # the warm chunk
    reps = 3
    t = time_replays(torch, graph, reps)
    ms = 1e3 * sum(t["host_s"]) / (reps * S.CHUNK)
    event_ms = statistics.median(t["event_ms"]) / S.CHUNK
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    final = graph.state
    guards = check_state(torch, f"scale {exchange}", final, start_pos)
    m = {"R": R_SCALE, "exchange": exchange, "ms_per_tick": ms,
         "x_real_time": (1e3 / params.hz) / ms, "capture_s": capture_s, **guards}
    log(f"[scale] {exchange}: built R={R_SCALE} in {build_s:.2f} s; state {state_mb:.1f} MB; "
        f"captured {S.CHUNK} ticks in {capture_s:.2f} s (warm-up chunk included), launches "
        f"a chunk {graph.launches}")
    log(S.line(m))
    log(f"[scale] {exchange}: {reps} chunks: {ms:.3f} ms/tick host clock, {event_ms:.3f} ms/tick "
        f"by CUDA events over a replay (median of {reps}); peak memory {peak_mb:.1f} MB "
        f"(torch.cuda.max_memory_allocated); moved {guards['moved']:.1f} m")
    log(json.dumps(metric_line(params, exchange, R_SCALE, guards["mean_degree"],
                               guards["nbr_overflow"], 1e3 / ms, "graph")))

    # 10 eager ticks against one replay, from the same state
    snapshot = clone_state(final)
    eager = T.run_ticks(snapshot, sdf, params, S.CHUNK)
    graph.replay()
    bad = differing_fields(torch, graph.state, eager)
    if bad:
        raise AssertionError(f"scale {exchange}: a replay differs from 10 eager ticks in {bad}")
    log(f"[scale] {exchange}: one replay bit-equal to {S.CHUNK} eager ticks in every field")
    del eager
    # device time: one replay (where the profiler records the graph's
    # kernels) and one eager tick
    prof_graph = profile(graph.replay, required=False)
    state = clone_state(graph.state)
    prof = profile(lambda: T.run_ticks(state, sdf, params, 1))
    dev_ms = prof_graph["device_us"] / S.CHUNK / 1e3 if prof_graph else None
    log(f"[scale] {exchange}: device time per tick {prof['device_us'] / 1e3:.3f} ms in a "
        f"profiled eager tick ({prof['launches']} cudaLaunchKernel); in a profiled replay "
        + (f"{dev_ms:.3f} ms, busy share of the graph's tick {dev_ms / ms:.1%}"
           if dev_ms is not None else "not recorded, busy share not recorded"))
    log(f"[scale] {exchange}: one eager tick by phase, ms (synchronised host timers; "
        f"the slot pieces lie within iterate_gbp): " + ", ".join(
            f"{name} {ms_:.3f}" for name, ms_ in tick_phases(torch, state, sdf, params).items()))
    bounds = scale_bounds(torch, state, params, sdf, exchange)
    kernels = {}
    for name, kname in KERNEL_NAMES.items():
        if not graph.launches[name]:
            continue
        # launches per tick are the capture's count; the device time per
        # launch comes from the profiled replay where it recorded this
        # kernel, else from the profiled eager tick, and says which. A
        # profiler's count only divides its own time (it may miss a launch
        # at its window's edge)
        source, hits = "graph replay", []
        if prof_graph is not None:
            hits = [(n, us) for key, (n, us) in prof_graph["kernels"].items() if kname in key]
        if not hits:
            source = "eager tick"
            hits = [(n, us) for key, (n, us) in prof["kernels"].items() if kname in key]
        count = sum(n for n, _ in hits)
        us = sum(u for _, u in hits) / count if count else None
        per_tick = graph.launches[name] / S.CHUNK
        b = bounds[name]
        kernels[name] = {"device_us": us, "device_us_of": source if count else "not recorded",
                         "launches_per_tick": per_tick, **b}
        log(f"[scale] {exchange}: {name} x {per_tick:g} a tick (capture's count), "
            + (f"{us:.3f} us per launch (torch.profiler of one {source})" if count
               else "device time not recorded")
            + f" against a bound of {1e3 * b['bound_ms']:.3f} us ({b['bound_by']})")
    return kernels


# --------------------------------------------------------------------------
# phase 9: the Simulator shell
# --------------------------------------------------------------------------

# The Circle Experiment as BASELINE.md cites the reference's
# config/scenarios/Circle Experiment/config.toml:49-74 (iterations,
# horizon, speed, comms, rate, seed, the inter-robot sigma), with the
# sweep's largest robot count (50, scripts/run-circle-expertiment.fish:24)
# on a 50 m-radius circle. The robot radius, 2.5 m, is the one
# tests/test_config_env.py:test_circle_formation_positions places this
# formation's robots with, and the environment an empty 150 m tile (the
# reference's files are not in the repo). The JAX Simulator on the CPU
# finishes this scenario in 200 ticks, mean distance 105.0 m; with every
# radius 2 m, 11 of the 50 robots jam for good, on the card as in JAX.
CIRCLE_TOML = """
[simulation]
hz = 10.0
prng-seed = 805
max-time = 120.0

[gbp]
sigma-factor-interrobot = 0.005
[gbp.iteration-schedule]
internal = 50
external = 10
schedule = "interleave-evenly"

[robot]
target-speed = 15.0
planning-horizon = 5.0
[robot.communication]
radius = 50.0
failure-rate = {failure_rate}
"""
CIRCLE_RADIUS = "[robot.radius]\nmin = {r}\nmax = {r}\n"
CIRCLE_ROBOTS = 50
# chunk sizes: the Circle Experiment's run and the checkpoint check, the
# comms-failure runs (an antenna sample after each chunk), the missions'
# runs (chunks of 5 while a mission is active), the swarm-scale run
SIM_CHUNK = 100
FAILURE_CHUNK = 5
MISSION_CHUNK = 20
SWARM_R = 1024
SWARM_TICKS = 100
FAILURE_RATE = 0.7


def circle_formation_doc(robots: int, radius: float) -> dict:
    """The Circle Experiment's formation, as a formation file holds it."""
    circle = {"circle": {"radius": radius, "center": {"x": 0.5, "y": 0.5}}}
    return {
        "robots": robots,
        "initial-position": {"shape": circle, "placement-strategy": "equal"},
        "waypoints": [{"shape": circle, "projection-strategy": "cross"}],
        # a robot finishes where its current position reaches its goal
        # (the default, the horizon variable's, finishes 75 m early)
        "finished-when-intersects": {"intersects-with": "current"},
    }


def circle_scenario(robots: int = CIRCLE_ROBOTS, radius: float = 50.0, tile: float = 150.0,
                    failure_rate: float = 0.0, toml: str = CIRCLE_TOML, robot_radius=2.5,
                    name="Circle Experiment"):
    """A Circle Experiment Scenario built in memory (TOML text, a formation
    dict, an empty environment): no file is read and no YAML parsed."""
    from magics_tpu_torch.config.formation import Formation, FormationGroup
    from magics_tpu_torch.config.loader import Scenario
    from magics_tpu_torch.config.schema import Config
    from magics_tpu_torch.env.model import Environment, SdfSettings

    formation = Formation.parse(circle_formation_doc(robots, radius))
    env = Environment(grid=["█"], tile_size=tile, path_width=0.1325,
                      sdf=SdfSettings(resolution=200, expansion=0.1, blur=0.01))
    text = toml.format(failure_rate=failure_rate) + CIRCLE_RADIUS.format(r=robot_radius)
    return Scenario(name=name, config=Config.from_toml(text),
                    environment=env, formations=FormationGroup([formation]))


# One tick, kernels against plain passes: 60 slots of float32 roundoff in
# two summation orders compound, so a whole tick is not held to RTOL (each
# kernel is, alone, at the same shapes). On the CPU the kernels' plain
# versions against the plain passes, one Circle tick from tick 30, differ
# by up to 6.1e-4 of scale (the inter-robot messages); a wrong term moves
# an entry by O(its scale), so 1e-2 of scale still catches it.
TICK_RTOL = 1e-2


def state_fields_compare(torch, label: str, got, want) -> dict:
    """Two states after one tick, the kernels' and the plain passes': each
    vector or matrix of the belief and message fields within TICK_RTOL of
    its own scale (gbp_slot.scaled_error), positions within SMALL_DRIFT_M,
    the belief guard's decisions flipped on at most MAX_FLIP_SHARE of the
    (robot, variable) pairs, the discrete fields equal."""
    from magics_tpu_torch.core.linalg import belief_covariance
    from magics_tpu_torch.kernels.gbp_slot import RESPONSE_OPERAND, scaled_error

    fields = ("belief_eta", "belief_lam", "belief_mean", "snap_eta", "snap_lam", "snap_mu",
              "dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu", "dyn_f2v_eta", "dyn_f2v_lam",
              "obs_v2f_mu", "obs_f2v_eta", "obs_f2v_lam", "ir_v2f_ext_pos", "ir_f2v_ext",
              "ext_inbox", "pos")
    rel = {}
    for name in fields:
        refs = {n: getattr(want, n) for n in (name, RESPONSE_OPERAND.get(name)) if n}
        rel[name] = scaled_error(name, getattr(got, name), refs, hot_layout=False)
    valid = [(lam.abs() > 1e-6).any(-1).any(-1) & belief_covariance(lam)[1]
             for lam in (got.belief_lam, want.belief_lam)]
    flips = int((valid[0] != valid[1]).sum())
    exact = [n for n in ("nbr_idx", "nbr_mask", "ir_int_seeded", "msg_counts", "active",
                         "completed") if not torch.equal(getattr(got, n), getattr(want, n))]
    worst = max(rel, key=rel.get)
    live = int((want.ir_f2v_ext != 0).any(dim=-1).sum())
    log(f"[sim] {label}: kernels vs plain passes, worst field {worst} {rel[worst]:.3e} of "
        f"scale, belief-guard flips {flips} of {valid[0].numel()}, {live} live inter-robot "
        f"messages, max |dpos| {float((got.pos - want.pos).abs().max()):.3e} m; every field "
        f"over its own scale: " + ", ".join(f"{f} {e:.1e}" for f, e in rel.items() if e > 0.0))
    drift = float((got.pos - want.pos).abs().max())
    bad = {f: e for f, e in rel.items() if e > TICK_RTOL}
    if (bad or flips > MAX_FLIP_SHARE * valid[0].numel() or exact or not live
            or drift >= SMALL_DRIFT_M):
        raise AssertionError(f"{label}: fields past {TICK_RTOL}: {bad}; flips {flips}; "
                             f"discrete fields differ {exact}; live messages {live}; "
                             f"drift {drift} m")
    return {"worst_field": worst, "worst_rel": rel[worst], "flips": flips, "drift_m": drift}


def gather_bits(torch, state, label: str) -> None:
    """The row gather bit-equal to its plain version at every call site of
    `state`'s shapes."""
    from magics_tpu_torch.kernels import layout as L

    for site, (tab, idx, m) in gather_sites(torch, state).items():
        if not torch.equal(L.gather_rows(tab, idx, m), L.gather_rows_reference(tab, idx, m)):
            raise AssertionError(f"gather_rows {label} {site}: differs from its plain version")
    R, K = state.nbr_idx.shape
    log(f"[sim] gather_rows {label} (R={R}, K={K}): bit-equal to its plain version at all "
        f"four call sites")


def slot_kernels_check(torch, state, params, sdf, label: str) -> None:
    """K1 and K2 against their plain versions on `state`'s slot inputs."""
    from magics_tpu_torch.kernels import gbp_slot as G
    from magics_tpu_torch.kernels import hot as HOT

    sp = HOT.slot_params(params)
    world = (params.world_width, params.world_height)
    h = slot_inputs(state, params)
    compare(torch, f"internal_slot {label}", G.internal_slot(h, sdf, world, sp),
            G.internal_slot_fused_reference(h, sdf, world, sp), max_flips=0)
    var_in = {name: h[name] for name in G._VAR_IN_FIELDS}
    want = G.variable_slot_reference(var_in, sp)
    compare(torch, f"variable_slot {label}", G.variable_slot(var_in, sp), want,
            max_flips=MAX_FLIP_SHARE * want["belief_mean"][0].numel())


def kernels_at(torch, state, params, sdf, label: str) -> None:
    """Every kernel of the path alone against its plain version on
    `state`'s inputs, at its shapes: K1 and K2 (slot_kernels_check), K3
    (interrobot_compare) and K4 (gather_bits). No whole tick is compared:
    on the chaotic crossings one float32 tick of the kernels' path and of
    the plain passes differs by up to 1.8e-2 of scale (the inter-robot
    messages, the circle at tick 15, both on the CPU), past TICK_RTOL."""
    from magics_tpu_torch.kernels import ir_slot as IR

    slot_kernels_check(torch, state, params, sdf, label)
    interrobot_compare(torch, IR.sender_inputs(state, params), params.sigma_factor_interrobot,
                       label)
    gather_bits(torch, state, label)


def wide_k_check(torch) -> None:
    """K3 and K4 at K=128, V=21 on a synthetic state: 160 robots on a 100 m
    circle, every pair within the 400 m comms radius, so all 128 slots fill
    (K3 splits a robot's 128 x 20 factors over blocks of at most 512
    threads), after 2 ticks; K3 on interrobot_check's synthetic variant."""
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

    params, state, sdf = build_scenario(
        circle_formation(160, circle_radius=100.0, target_speed=15.0, robot_radius=1.0),
        target_speed=15.0, planning_horizon=5.0, hz=10.0, comms_radius=400.0, internal=4,
        external=2, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=128,
        world=(400.0, 400.0), despawn_on_final_waypoint=False, tracking_enabled=False)
    state = T.run_ticks(state, sdf, params, 2)
    if int(state.nbr_mask.sum(dim=1).min()) != 128 or params.n_vars != 21:
        raise AssertionError("wide-K input: not every slot filled")
    interrobot_check(torch, state, params, "synthetic K=128")
    gather_bits(torch, state, "synthetic K=128")


def circle_phase(torch) -> dict:
    """(a) The Circle Experiment through Simulator.run on the card, its
    export and analysis; (b) the kernels at its shapes (K=49)."""
    from magics_tpu_torch import analysis
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.graph.chunk import clone_state
    from magics_tpu_torch.io.diagnostics import DiagnosticsRecorder
    from magics_tpu_torch.profiling import profile
    from magics_tpu_torch.sim.simulator import Simulator

    t0 = time.perf_counter()
    sim = Simulator(circle_scenario())
    build_s = time.perf_counter() - t0
    p = sim.params
    if sim.state.device.type != "cuda" or not p.uses_kernels(sim.state.device):
        raise AssertionError(f"the Simulator's state is on {sim.state.device}, "
                             f"use_pallas={p.use_pallas}")
    log(f"[sim] (a) Circle Experiment: R={len(sim.specs)}, V={p.n_vars}, K={p.n_slots}, "
        f"{sum(i for i, _ in p.schedule)}i+{sum(e for _, e in p.schedule)}e, "
        f"exchange {p.ext_exchange}; built in {build_s:.2f} s")
    reset_counts()
    t0 = time.perf_counter()
    result = sim.run(chunk_ticks=SIM_CHUNK)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    graph = sim.graphs[SIM_CHUNK]
    per_tick = {k: v / SIM_CHUNK for k, v in graph.launches.items()}
    capture_s = sum(s for _, s in sim.stats.captures)
    if per_tick != {k: float(v) for k, v in LAUNCHES_PER_TICK["sender"].items()}:
        raise AssertionError(f"(a): capture launches per tick {per_tick}")
    if not all(launches.values()):
        raise AssertionError(f"(a): a kernel of the Simulator's path never launched: {launches}")
    if (result["completed"] != len(sim.specs) or result["makespan"] >= 60.0
            or result["nbr_overflow"] != 0):
        raise AssertionError(f"(a) Circle Experiment contract broken: {result}")
    if sim.stats.max_graphs_alive > 2 or len(sim.graphs) > 2:
        raise AssertionError(f"(a): {sim.stats.max_graphs_alive} graphs alive")
    replay_ms = 1e3 * (run_s - capture_s) / result["ticks"]
    t0 = time.perf_counter()
    DiagnosticsRecorder(n_vars=p.n_vars).sample(sim.state, p, result["ticks"] * sim.dt)
    sample_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    sim._harvest_log(sim.state)
    harvest_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    export = sim.export()
    export_ms = 1e3 * (time.perf_counter() - t0)
    a = analysis.analyse(export)
    ldj, dist = a["ldj"], a["distance_travelled"]
    if (ldj is None or dist is None or not np.isfinite([ldj["mean"], dist["mean"]]).all()
            or dist["mean"] < 100.0 or ldj["n"] != len(sim.specs)):
        raise AssertionError(f"(a) analysis: ldj {ldj}, distance {dist}")
    log(f"[sim] (a) {result}")
    log(f"[sim] (a) run {run_s:.2f} s: capture {capture_s:.2f} s ({SIM_CHUNK} ticks, warm-up "
        f"chunk included), {replay_ms:.3f} ms a tick beside it (replays, diagnostics, the "
        f"last chunk's harvest); graphs alive {sorted(sim.graphs)}, at most "
        f"{sim.stats.max_graphs_alive}; {sim.stats.graph_chunks} graph chunks, "
        f"{sim.stats.eager_chunks} eager; launches per tick (capture) {per_tick}; launches "
        f"in the run {launches}")
    log(f"[sim] (a) host ms: diagnostics.sample {sample_ms:.3f}, _harvest_log {harvest_ms:.3f} "
        f"({len(sim.specs)} robots x {int(sim.state.log_head)} samples), export {export_ms:.3f}; "
        f"analysis: LDJ mean {ldj['mean']:.3f}, distance mean {dist['mean']:.3f} m, makespan "
        f"{a['makespan']:.1f} s, rr_collisions {result['rr_collisions']}")

    # (b) one tick from mid-crossing with the kernels and with the plain
    # passes, each kernel at these shapes, and their device times
    sim.reset()
    sim.run(max_ticks=30, chunk_ticks=SIM_CHUNK)    # 30 eager ticks: a partial chunk
    mid = clone_state(sim.state)
    kern = T.step(mid, sim.sdf, p, sim.env_dist, generator=sim.generator)
    plain = T.step(mid, sim.sdf, dataclasses.replace(p, use_pallas=False), sim.env_dist,
                   generator=sim.generator)
    tick_cmp = state_fields_compare(torch, "(b) one tick at K=49", kern, plain)
    slot_kernels_check(torch, mid, p, sim.sdf, "Circle K=49")
    interrobot_check(torch, mid, p, "Circle K=49")
    gather_bits(torch, mid, "Circle K=49")
    wide_k_check(torch)
    prof = profile(lambda: T.step(mid, sim.sdf, p, sim.env_dist, generator=sim.generator))
    us = {}
    for name, kname in KERNEL_NAMES.items():
        hits = [(n, t) for key, (n, t) in prof["kernels"].items() if kname in key]
        count = sum(n for n, _ in hits)
        us[name] = sum(t for _, t in hits) / count if count else None
    log(f"[sim] (b) device us per launch in one eager Circle tick at tick 30 (torch.profiler): "
        + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not recorded"
                    for k, v in us.items()))
    return {"sim": sim, "launches": launches, "launches_per_tick": per_tick, "device_us": us,
            "tick_compare": tick_cmp, "export": export, "run_s": run_s, "ticks": result["ticks"]}


def checkpoint_phase(torch, sim, tmpdir) -> None:
    """(c) reset() gives a fresh Simulator's initial state; a checkpoint at
    tick 100 resumed in a fresh Simulator runs 50 ticks bit-equal to the
    uninterrupted run, in every field."""
    from magics_tpu_torch.sim.simulator import Simulator

    fresh = Simulator(circle_scenario())
    sim.reset()
    bad = differing_fields(torch, sim.state, fresh.state)
    if bad:
        raise AssertionError(f"(c): reset() differs from a fresh state in {bad}")
    sim.run(max_ticks=100, chunk_ticks=SIM_CHUNK)
    path = f"{tmpdir}/circle_100.npz"
    t0 = time.perf_counter()
    sim.save_checkpoint(path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    sim.run(max_ticks=150, chunk_ticks=SIM_CHUNK)
    t0 = time.perf_counter()
    fresh.resume(path)
    resume_ms = 1e3 * (time.perf_counter() - t0)
    fresh.run(max_ticks=150, chunk_ticks=SIM_CHUNK)
    bad = differing_fields(torch, sim.state, fresh.state)
    if bad or int(fresh.state.tick) != 150:
        raise AssertionError(f"(c): the resumed run differs in {bad}")
    log(f"[sim] (c) reset() bit-equal to a fresh Simulator's state; checkpoint at tick 100 "
        f"(save {save_ms:.1f} ms, resume {resume_ms:.1f} ms), resumed in a fresh Simulator "
        f"and run to 150: bit-equal to the uninterrupted run in all "
        f"{len(vars(sim.state))} fields")


def failure_phase(torch) -> None:
    """(d) comms failure at the Communications Failure Experiment's rate:
    one seed twice bit-equal (and again after reset()), another seed
    differs, the failed-antenna share of the active robots after each
    chunk within 0.05 of the rate."""
    from magics_tpu_torch.sim.simulator import Simulator

    # robots stay after they finish, so that every chunk samples all 50
    toml = CIRCLE_TOML.replace("max-time = 120.0", "max-time = 120.0\n"
                               "despawn-robot-when-final-waypoint-reached = false")

    def run(seed):
        sim = Simulator(circle_scenario(failure_rate=FAILURE_RATE, toml=toml), seed=seed)
        off = []

        def sample(state, tick):
            act = state.active
            off.append(((~state.antenna & act).sum(), act.sum()))

        sim.run(max_ticks=200, chunk_ticks=FAILURE_CHUNK, on_chunk=sample)
        failed = sum(int(a) for a, _ in off) / max(1, sum(int(b) for _, b in off))
        return sim, failed, sum(int(b) for _, b in off)

    a, share_a, n = run(805)
    b, share_b, _ = run(805)
    c, _, _ = run(31)
    bad = differing_fields(torch, a.state, b.state)
    if bad:
        raise AssertionError(f"(d): one seed, two runs differ in {bad}")
    if torch.equal(a.state.pos, c.state.pos):
        raise AssertionError("(d): another seed gave the same run")
    again = a.state
    a.reset()
    a.run(max_ticks=200, chunk_ticks=FAILURE_CHUNK)
    bad = differing_fields(torch, again, a.state)
    if bad:
        raise AssertionError(f"(d): the run after reset() differs in {bad}")
    if abs(share_a - FAILURE_RATE) > 0.05 or abs(share_b - share_a) > 0:
        raise AssertionError(f"(d): failed share {share_a} / {share_b} at rate {FAILURE_RATE}")
    log(f"[sim] (d) comms failure {FAILURE_RATE}: seed 805 twice bit-equal in every field, "
        f"again after reset(); seed 31 differs; failed-antenna share {share_a:.4f} over {n} "
        f"robot samples; generator on {a.generator.device}")


MISSION_TOML = """
[simulation]
hz = 10.0
prng-seed = 7
max-time = 60.0

[gbp.iteration-schedule]
internal = 10
external = 10

[robot]
target-speed = 10.0
planning-horizon = 3.0
[robot.radius]
min = 1.0
max = 1.0
[robot.communication]
radius = 20.0
failure-rate = 0.0
"""


def mission_phase(torch) -> None:
    """(e) in-flight rrt-star missions on the builtin intersection: two
    robots along each arm, planned during the run (deterministic polling),
    chunks of 5 while a mission is active; every mission done in time."""
    from magics_tpu_torch.config.formation import Formation, FormationGroup
    from magics_tpu_torch.config.loader import Scenario
    from magics_tpu_torch.config.schema import Config
    from magics_tpu_torch.env import builtin
    from magics_tpu_torch.sim.simulator import Simulator

    def seg(a, b):
        return {"line-segment": [{"x": a[0], "y": a[1]}, {"x": b[0], "y": b[1]}]}

    def formation(start, goal):
        return Formation.parse({
            "robots": 2, "planning-strategy": "rrt-star",
            "initial-position": {"shape": seg(*start), "placement-strategy": "equal"},
            "waypoints": [{"shape": seg(*goal), "projection-strategy": "identity"}],
        })

    forms = [formation(((0.05, 0.48), (0.05, 0.52)), ((0.95, 0.48), (0.95, 0.52))),
             formation(((0.48, 0.05), (0.52, 0.05)), ((0.48, 0.95), (0.52, 0.95)))]
    scenario = Scenario(name="Intersection missions", config=Config.from_toml(MISSION_TOML),
                        environment=builtin.intersection(), formations=FormationGroup(forms))
    t0 = time.perf_counter()
    sim = Simulator(scenario)
    if sim.mission is None or not sim.mission.deterministic:
        raise AssertionError("(e): no deterministic mission manager")
    reset_counts()
    result = sim.run(chunk_ticks=MISSION_CHUNK)
    run_s = time.perf_counter() - t0
    states = {m.state for m in sim.mission.missions.values()}
    backend = sim._global_planner().backend
    load_ms = sim.stats.load_ms()
    if states != {"done"} or result["completed"] != len(sim.specs):
        raise AssertionError(f"(e): missions {states}, {result}")
    if sim.stats.max_graphs_alive > 2:
        raise AssertionError(f"(e): {sim.stats.max_graphs_alive} graphs alive")
    log(f"[sim] (e) {len(sim.specs)} rrt-star robots on the intersection: every mission done; "
        f"{result}; planner backend {backend}; {run_s:.2f} s with the build; captures "
        f"{[(n, round(s, 2)) for n, s in sim.stats.captures]}, at most "
        f"{sim.stats.max_graphs_alive} graphs alive, {sim.stats.graph_chunks} graph chunks, "
        f"{sim.stats.eager_chunks} eager; {len(load_ms)} loads, device ms each: median "
        f"{statistics.median(load_ms) if load_ms else float('nan'):.4f}, max "
        f"{max(load_ms) if load_ms else float('nan'):.4f}")


def swarm_scenario():
    """The bench ring (1024 robots on an 800 m circle) as a Simulator scenario."""
    toml = CIRCLE_TOML.replace("max-time = 120.0", "max-time = 30.0").replace(
        "sigma-factor-interrobot = 0.005", "sigma-factor-interrobot = 0.01")
    return circle_scenario(robots=SWARM_R, radius=800.0, tile=2000.0, toml=toml,
                           robot_radius=2.0, name="Swarm circle")


def swarm_phase(torch, graph_ms: float) -> None:
    """(f) the shell at swarm scale: a 1024-robot circle (the bench's
    geometry and slots, K=32) for 100 ticks through Simulator.run in
    10-tick graphs; then 3 replays of the same graph alone from the state
    it reached, and phase 6's sender graph, beside it."""
    from magics_tpu_torch.profiling import profile
    from magics_tpu_torch.sim.simulator import Simulator

    sim = Simulator(swarm_scenario(), n_slots=32)
    sim.run(max_ticks=GRAPH_CHUNK, chunk_ticks=GRAPH_CHUNK)     # capture
    graph = sim.graphs[GRAPH_CHUNK]
    per_tick = {k: v / GRAPH_CHUNK for k, v in graph.launches.items()}
    if per_tick != {k: float(v) for k, v in LAUNCHES_PER_TICK["sender"].items()}:
        raise AssertionError(f"(f): capture launches per tick {per_tick}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = sim.run(max_ticks=GRAPH_CHUNK + SWARM_TICKS, chunk_ticks=GRAPH_CHUNK)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SWARM_TICKS
    t0 = time.perf_counter()
    sim._harvest_log(sim.state)
    harvest_ms = 1e3 * (time.perf_counter() - t0)
    if result["nbr_overflow"] or not bool(torch.isfinite(sim.state.pos).all()):
        raise AssertionError(f"(f): {result}")
    loop_ms = ms - harvest_ms / SWARM_TICKS
    alone = time_replays(torch, graph, 3)
    alone_ms = 1e3 * sum(alone["host_s"]) / (3 * GRAPH_CHUNK)
    prof = profile(graph.replay, required=False)
    dev = ("not recorded" if prof is None
           else f"{prof['device_us'] / GRAPH_CHUNK / 1e3:.3f} ms (torch.profiler of one replay)")
    log(f"[sim] (f) R={SWARM_R}, K=32, 50i+10e: {SWARM_TICKS} ticks through Simulator.run in "
        f"{GRAPH_CHUNK}-tick graphs (launches per tick {per_tick}): {ms:.3f} ms/tick with the "
        f"end's harvest, {loop_ms:.3f} without it (a load, then replays with a diagnostics "
        f"sample a chunk); the same graph's replays alone {alone_ms:.3f} ms/tick, device "
        f"{dev}: the shell's overhead {loop_ms - alone_ms:+.3f} ms/tick; phase 6's sender "
        f"graph (ticks 120-150 of the bench) {graph_ms:.3f} ms/tick; _harvest_log alone "
        f"{harvest_ms:.1f} ms ({SWARM_R} robots x {int(sim.state.log_head)} samples); mean "
        f"degree {float(sim.state.nbr_mask.sum()) / SWARM_R:.2f}")


def simulator_phase(torch, graph_ms: float) -> dict:
    """Phase 9 (a)-(f); returns (a)'s launches and (b)'s device times."""
    import tempfile

    t0 = time.perf_counter()
    out = circle_phase(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        checkpoint_phase(torch, out.pop("sim"), tmpdir)
    failure_phase(torch)
    mission_phase(torch)
    swarm_phase(torch, graph_ms)
    log(f"[sim] phase 9 in {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 10: the user's surfaces
# --------------------------------------------------------------------------

SURFACE_CHUNK = 100     # the CLI's run chunk (Simulator.run's default)
DRIVE_CHUNK = 5         # the live view's chunk (the CLI's --serve)
DRIVE_TICKS = 100       # ticks the live view runs before the browser quits


def write_scenario(root, scenario, formation: dict):
    """A scenario directory the CLI reads without PyYAML: config.toml as
    save_settings writes it, environment.yaml and formation.yaml as JSON
    documents (config.dump.json_yaml). Checks that it loads back to
    `scenario`."""
    from pathlib import Path

    from magics_tpu_torch.config.dump import json_yaml
    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.config.schema import config_to_toml

    env = scenario.environment
    if env.obstacles:
        raise AssertionError("write_scenario writes obstacle-free environments only")
    d = Path(root) / scenario.name
    d.mkdir()
    (d / "config.toml").write_text(config_to_toml(scenario.config))
    (d / "environment.yaml").write_text(json_yaml({
        "tiles": {"grid": env.grid, "settings": {
            "tile-size": env.tile_size, "path-width": env.path_width,
            "obstacle-height": env.obstacle_height,
            "sdf": {"resolution": env.sdf.resolution, "expansion": env.sdf.expansion,
                    "blur": env.sdf.blur}}},
        "obstacles": []}))
    (d / "formation.yaml").write_text(json_yaml({"formations": [formation]}))
    back = load_scenario(d)
    if (back.environment != env or back.formations != scenario.formations
            or config_to_toml(back.config) != config_to_toml(scenario.config)):
        raise AssertionError(f"{d} does not load back to the scenario it was written from")
    return d


def timed_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def cli_run_phase(torch, circle_dir, tmpdir, circle: dict) -> dict:
    """(b) `cli.main`'s run of the Circle Experiment on the card, in process,
    with --export --snapshot --player --checkpoint: all robots complete, the
    export bit-equal to 9(a)'s Simulator.run export (its config tree is the
    one save_settings wrote, the same effective config), the launches, the
    PNG, the player; then each output's host ms on its own."""
    import contextlib
    import io
    import tomllib
    from pathlib import Path

    from magics_tpu_torch import cli
    from magics_tpu_torch.config.schema import config_to_toml
    from magics_tpu_torch.env.sdf import env_to_image
    from magics_tpu_torch.viz.player import build_player
    from magics_tpu_torch.viz.png import encode_png, idat_pixels
    from magics_tpu_torch.viz.render import render_trajectories

    out = {k: Path(tmpdir) / f"circle.{k}" for k in ("json", "png", "html", "npz")}
    stdout = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        code, sim = cli.session(["-i", str(circle_dir), "--export", str(out["json"]),
                                 "--snapshot", str(out["png"]), "--player", str(out["html"]),
                                 "--checkpoint", str(out["npz"]), "--quiet"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    if code != 0 or sim.device.type != "cuda" or summary["completed"] != len(sim.specs):
        raise AssertionError(f"(b) the CLI's run: exit {code}, {sim.device}, {summary}")
    graph = sim.graphs[SURFACE_CHUNK]
    per_tick = {k: v / SURFACE_CHUNK for k, v in graph.launches.items()}
    if per_tick != {k: float(v) for k, v in LAUNCHES_PER_TICK["sender"].items()}:
        raise AssertionError(f"(b): capture launches per tick {per_tick}")
    if not all(launches.values()):
        raise AssertionError(f"(b): a kernel never launched in the CLI's run: {launches}")
    export = json.loads(out["json"].read_text())
    want = json.loads(json.dumps(circle["export"]))
    config = export.pop("config")
    if config != tomllib.loads(config_to_toml(circle_scenario().config)):
        raise AssertionError("(b): the export's config is not the scenario's")
    want.pop("config")
    if export != want:
        bad = sorted(k for k in want if export.get(k) != want[k])
        raise AssertionError(f"(b): the CLI's export differs from 9(a)'s in {bad}")
    env = sim.scenario.environment
    obstacle = env_to_image(env, expansion=0.0) == 0
    export = sim.export()
    img = render_trajectories(export, None, obstacle=obstacle, world=env.world_size)
    if not np.array_equal(idat_pixels(out["png"].read_bytes()), img):
        raise AssertionError("(b): the snapshot PNG does not hold render_trajectories' array")
    if json.dumps(export, separators=(",", ":")) not in out["html"].read_text():
        raise AssertionError("(b): the player does not embed the export")
    if not out["npz"].stat().st_size:
        raise AssertionError("(b): no checkpoint")
    ms_tick = 1e3 * summary["wall_s"] / summary["ticks"]
    run_ms_tick = 1e3 * circle["run_s"] / circle["ticks"]
    log(f"[surfaces] (b) cli.main -i '{circle_dir.name}' --export --snapshot --player "
        f"--checkpoint --quiet on {sim.device}: {summary}; exit {code} in {wall_s:.2f} s; "
        f"wall_s {summary['wall_s']} = {ms_tick:.3f} ms/tick (capture included) against "
        f"9(a)'s Simulator.run {circle['run_s']:.2f} s = {run_ms_tick:.3f} ms/tick; captures "
        f"{[(n, round(sec, 2)) for n, sec in sim.stats.captures]}, graphs alive "
        f"{sorted(sim.graphs)}")
    log(f"[surfaces] (b) launches per tick (capture) {per_tick}; launches in the run "
        f"{launches}; export bit-equal to 9(a)'s (config: save_settings' tree of the same "
        f"config); the PNG's IDAT inflates to render_trajectories' {img.shape} array; the "
        f"player embeds the export")
    _, export_ms = timed_ms(sim.export)
    _, render_ms = timed_ms(lambda: render_trajectories(export, None, obstacle=obstacle,
                                                        world=env.world_size))
    png, encode_ms = timed_ms(lambda: encode_png(img))
    _, snapshot_ms = timed_ms(lambda: render_trajectories(
        export, out["png"], obstacle=obstacle, world=env.world_size))
    _, player_ms = timed_ms(lambda: build_player(export))
    _, ckpt_ms = timed_ms(lambda: sim.save_checkpoint(out["npz"]))
    log(f"[surfaces] (b) host ms: export {export_ms:.1f}, snapshot {snapshot_ms:.1f} (render "
        f"{render_ms:.1f}, PNG encode {encode_ms:.1f} for {len(png)} bytes), player "
        f"{player_ms:.1f}, checkpoint {ckpt_ms:.1f}")
    return {"launches": launches, "launches_per_tick": per_tick}


REPL_SCRIPT = (
    "import json, sys\n"
    "from magics_tpu_torch import cli\n"
    "code, sim = cli.session(sys.argv[1:])\n"
    "print(json.dumps({'code': code, 'scenario': sim.scenario.name, 'dtype': str(sim.state.pos.dtype),\n"
    "                  'device': str(sim.device), 'captures': [n for n, _ in sim.stats.captures],\n"
    "                  'graphs': sorted(sim.graphs), 'max_graphs_alive': sim.stats.max_graphs_alive}))\n"
)


def repl_phase(torch, circle_dir, ring_dir, tmpdir) -> None:
    """(c) the REPL in a subprocess (`cli.session`, what `python -m
    magics_tpu_torch.cli` runs, then the sim it ended on), float64 on the
    card: ticks advance exactly, `load` switches to the ring and --export
    writes the ring's export, the dtype and device are kept, no capture per
    step size."""
    import subprocess
    from pathlib import Path

    out = Path(tmpdir) / "repl.json"
    cmds = ("step 3\nstatus\nstep 3\nrun 1\nstatus\nset comms-radius 45\n"
            f"load {ring_dir.name}\nstatus\nstep 5\nstatus\nquit\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", REPL_SCRIPT, "-i", str(circle_dir), "--scenarios-dir",
         str(ring_dir.parent), "--interactive", "--dtype", "f64", "--export", str(out),
         "--quiet"],
        input=cmds, capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent,
    )
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(c) the REPL exited {proc.returncode}: {proc.stderr[-3000:]}")
    statuses = [json.loads(ln) for ln in proc.stderr.splitlines() if ln.startswith("{")]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    ticks = [(s["ticks"], s["robots"]) for s in statuses]
    if ticks != [(3, CIRCLE_ROBOTS), (16, CIRCLE_ROBOTS), (0, SWARM_R), (5, SWARM_R)]:
        raise AssertionError(f"(c): statuses {statuses}")
    if "error:" in proc.stderr or "comms_radius = 45.0" not in proc.stderr:
        raise AssertionError(f"(c): {proc.stderr[-3000:]}")
    export = json.loads(out.read_text())
    if (export["scenario"] != ring_dir.name or len(export["robots"]) != SWARM_R
            or abs(export["makespan"] - 0.5) > 1e-9):
        raise AssertionError(f"(c): --export after `load` is {export['scenario']!r}, "
                             f"{len(export['robots'])} robots, makespan {export['makespan']}")
    if (result["scenario"] != ring_dir.name or result["dtype"] != "torch.float64"
            or not result["device"].startswith("cuda") or result["captures"]
            or result["max_graphs_alive"] > 2):
        raise AssertionError(f"(c): the session ended on {result}")
    log(f"[surfaces] (c) REPL subprocess ({wall_s:.1f} s, interpreter start included): "
        f"statuses (ticks, robots) {ticks}; `set` -> comms_radius = 45.0; after `load` the "
        f"export is '{export['scenario']}' ({len(export['robots'])} robots, makespan "
        f"{export['makespan']} s); session ended on {result}")


def live_phase(torch, ring_dir) -> None:
    """(d) a LiveServer on port 0 over the ring (K=32, as 9f), `drive` on a
    thread at 5-tick chunks; over HTTP: pause, step 3, a `set`, resume, quit
    after DRIVE_TICKS ticks. Frames arrive, the log is harvested once, one
    graph is captured; then `run` in 100-tick chunks from where drive
    stopped, beside it."""
    import threading
    import urllib.request

    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.sim.simulator import Simulator
    from magics_tpu_torch.viz.live import LiveServer

    sim = Simulator(load_scenario(ring_dir), n_slots=32)
    harvests = []
    harvest = sim._harvest_log

    def counted(state):
        t0 = time.perf_counter()
        harvest(state)
        harvests.append(1e3 * (time.perf_counter() - t0))

    sim._harvest_log = counted
    live = LiveServer(sim, port=0)
    live.start()

    def post(cmd):
        req = urllib.request.Request(f"http://127.0.0.1:{live.port}/cmd",
                                     data=json.dumps(cmd).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError(f"(d): {cmd} refused")

    def frame_tick() -> int:
        return round(json.loads(live.frames_since(0)[1][-1])["t"] * sim.hz)

    def wait(pred, what):
        # reads the frames drive pushed, not the state: a read of the card
        # from this thread while drive's thread captures a graph would break
        # the capture
        deadline = time.monotonic() + 300
        while not pred(frame_tick()):
            if time.monotonic() > deadline or not thread.is_alive():
                raise AssertionError(f"(d): no {what}; the last frame's tick {frame_tick()}")
            time.sleep(0.01)

    _, push_ms = timed_ms(lambda: live.push(sim.state))
    summary = {}
    thread = threading.Thread(target=lambda: summary.update(live.drive(chunk_ticks=DRIVE_CHUNK)))
    try:
        post({"op": "pause"})
        thread.start()
        post({"op": "step", "n": 3})
        wait(lambda t: t == 3, "step 3")
        post({"op": "set", "key": "comms-radius", "value": "45"})
        t0, tick0 = time.perf_counter(), frame_tick()
        post({"op": "resume"})
        wait(lambda t: t >= DRIVE_TICKS, f"{DRIVE_TICKS} ticks")
        post({"op": "quit"})
        thread.join(timeout=300)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
    finally:
        live.stop()
    tick = int(sim.state.tick)
    if thread.is_alive() or summary.get("ticks") != tick or sim.params.comms_radius != 45.0:
        raise AssertionError(f"(d): drive ended at {summary}, tick {tick}, "
                             f"comms_radius {sim.params.comms_radius}")
    seq, frames = live.frames_since(0)
    last = json.loads(frames[-1])
    if seq < 2 + (tick - 3) // DRIVE_CHUNK or abs(last["t"] - tick * sim.dt) > 1e-9:
        raise AssertionError(f"(d): {seq} frames, the last at t={last['t']}, tick {tick}")
    if len(harvests) != 1 or [n for n, _ in sim.stats.captures] != [DRIVE_CHUNK]:
        raise AssertionError(f"(d): harvests {len(harvests)}, captures {sim.stats.captures}")
    capture_s = sim.stats.captures[0][1]
    drive_ms = 1e3 * (drive_s - capture_s - harvests[0] / 1e3) / (tick - tick0)
    # run in 100-tick chunks from where drive stopped: a capture, then 100
    # ticks of replays timed
    sim.run(max_ticks=tick + SURFACE_CHUNK, harvest=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(max_ticks=tick + 2 * SURFACE_CHUNK, harvest=False)
    torch.cuda.synchronize()
    run_ms = 1e3 * (time.perf_counter() - t0) / SURFACE_CHUNK
    log(f"[surfaces] (d) LiveServer on port {live.port} over '{ring_dir.name}' (R={SWARM_R}, "
        f"K={sim.params.n_slots}): pause, step 3, set comms-radius 45, resume, quit at tick "
        f"{tick}: {seq} frames, the last at t={last['t']} s; _harvest_log called "
        f"{len(harvests)} time ({harvests[0]:.1f} ms); captures {sim.stats.captures} "
        f"(the 5-tick graph, after the set); drive {drive_ms:.3f} ms/tick over ticks "
        f"{tick0}-{tick} at {DRIVE_CHUNK}-tick chunks (a replay, a push, a diagnostics sample, "
        f"a clone and a load each; its capture, {capture_s:.2f} s, and the harvest at its end "
        f"aside; {1e3 * drive_s / (tick - tick0):.3f} with them) against run "
        f"{run_ms:.3f} ms/tick at {SURFACE_CHUNK}-tick chunks; push {push_ms:.3f} ms "
        f"({SWARM_R} robots)")


def surfaces_phase(torch, circle: dict) -> dict:
    """Phase 10 (a)-(d); returns (b)'s launches."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        from pathlib import Path

        root = Path(tmpdir) / "scenarios"
        root.mkdir()
        circle_dir = write_scenario(root, circle_scenario(),
                                    circle_formation_doc(CIRCLE_ROBOTS, 50.0))
        ring_dir = write_scenario(root, swarm_scenario(), circle_formation_doc(SWARM_R, 800.0))
        log(f"[surfaces] (a) scenario directories '{circle_dir.name}' and '{ring_dir.name}': "
            f"config.toml as save_settings writes it, environment.yaml and formation.yaml as "
            f"JSON documents; each loads back to its in-memory scenario")
        out = cli_run_phase(torch, circle_dir, tmpdir, circle)
        repl_phase(torch, circle_dir, ring_dir, tmpdir)
        live_phase(torch, ring_dir)
    log(f"[surfaces] phase 10 in {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 11: the sharded path on the card
# --------------------------------------------------------------------------

SHARD_RANKS = 2
SHARD_TICKS = 5
SHARD_TIMEOUT_S = 300
# The sharded ranks against one process, float32 on the card: every
# robot's arithmetic is the same on both (the kernels and the plain ops work
# row by row, the collectives only move bytes, the sums they reduce are
# integers), so the float fields are expected bit-equal. Where one is not,
# it is printed with its largest error, and held to RTOL of each vector's
# or matrix's own scale (gbp_slot.scaled_error): float32 roundoff of a sum
# whose order a kernel chose by the tensor's size, amplified by the 4x4
# inverses of 5 ticks.
SHARD_RTOL = RTOL


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(exchange: str, backend: str, save: str) -> list:
    """SHARD_RANKS processes of `python -m magics_tpu_torch.parallel.launch`
    on the scale workload at R_SCALE (rank 0 saves the gathered final state
    to `save`): each rank's `rank_report`. Raises if a rank fails, exits
    non-zero, outlives SHARD_TIMEOUT_S or disagrees on the checksum."""
    import os
    import tempfile
    from pathlib import Path

    port = free_port()
    root = Path(__file__).resolve().parent
    procs, logs = [], []
    for rank in range(SHARD_RANKS):
        env = dict(os.environ, MAGICS_COORDINATOR=f"localhost:{port}",
                   MAGICS_NUM_PROCESSES=str(SHARD_RANKS), MAGICS_PROCESS_ID=str(rank),
                   PYTHONWARNINGS="ignore::FutureWarning")
        logs.append(tempfile.TemporaryFile("w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "magics_tpu_torch.parallel.launch", "--workload", "scale",
             "--robots", str(R_SCALE), "--ticks", str(SHARD_TICKS), "--exchange", exchange,
             "--backend", backend, "--seed", "0", "--check-sum", "--profile", "--save", save],
            cwd=root, env=env, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for log_file in logs:
        log_file.seek(0)
        outs.append(log_file.read())
        log_file.close()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"sharded {exchange} over {backend}: rank {rank} exited "
                                 f"{proc.returncode}:\n{out[-4000:]}")
    reports, sums = [], set()
    for out in outs:
        for line in out.splitlines():
            if line.startswith("rank_report "):
                reports.append(json.loads(line[len("rank_report "):]))
            elif line.startswith("rank=") and "abs_pos_sum=" in line:
                sums.add(line.split("abs_pos_sum=")[1])
            elif line.startswith(("processes=", "R=")):
                log(f"[shard] {exchange} {backend}: {line}")
    if len(reports) != SHARD_RANKS or len(sums) != 1:
        raise AssertionError(f"sharded {exchange}: {len(reports)} rank reports, checksums {sums}")
    log(f"[shard] {exchange} {backend}: every rank's abs_pos_sum {sums.pop()}")
    return sorted(reports, key=lambda r: r["rank"])


def sharded_compare(torch, exchange: str, saved: dict) -> dict:
    """The gathered sharded state against SHARD_TICKS one-process eager
    ticks on the card from the same start: discrete fields exact, float
    fields bit-equal or within SHARD_RTOL (printed)."""
    from magics_tpu_torch.bench.scale import scale_scenario
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels.gbp_slot import scaled_error

    params, state, sdf = scale_scenario(R_SCALE, exchange)
    start_pos = state.pos.clone()
    gen = torch.Generator(device="cuda").manual_seed(0)
    T.run_ticks(state, sdf, params, 1, generator=gen)        # warm-up, discarded
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = T.run_ticks(state, sdf, params, SHARD_TICKS, generator=gen)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0) / SHARD_TICKS
    log(f"[shard] {exchange}: one process, R={R_SCALE}: {one_ms:.3f} ms/tick (host clock, "
        f"{SHARD_TICKS} eager ticks after a warm-up tick)")
    guards = check_state(torch, f"shard {exchange} one process", want, start_pos)
    exact, floats = [], {}
    for name, w in vars(want).items():
        g = saved[name].to(w.device)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shard {exchange}: {name} {g.dtype}{tuple(g.shape)} against "
                                 f"{w.dtype}{tuple(w.shape)}")
        if bits_equal(torch, g, w):
            continue
        if w.is_floating_point():
            floats[name] = (float((g.double() - w.double()).abs().max()),
                            scaled_error(name, g, {name: w}, hot_layout=False))
        else:
            exact.append(name)
    if exact:
        raise AssertionError(f"shard {exchange}: discrete fields differ from one process: {exact}")
    if floats:
        log(f"[shard] {exchange}: float fields not bit-equal to one process (max |d|, of "
            f"scale): " + ", ".join(f"{n} {a:.3e} {r:.3e}" for n, (a, r) in floats.items()))
        bad = {n: r for n, (_, r) in floats.items() if r > SHARD_RTOL}
        if bad:
            raise AssertionError(f"shard {exchange}: fields past {SHARD_RTOL} of scale: {bad}")
    else:
        log(f"[shard] {exchange}: the gathered state of {SHARD_RANKS} ranks is bit-equal to "
            f"{SHARD_TICKS} one-process eager ticks in every field (moved "
            f"{guards['moved']:.1f} m, mean degree {guards['mean_degree']:.2f})")
    return {"bit_equal": not floats, "differing": {n: r for n, (_, r) in floats.items()},
            "one_process_ms": one_ms}


def shard_exchange(torch, exchange: str, backend: str, tmpdir) -> dict:
    """(a) for one exchange: the ranks, their reports checked, and the
    gathered state against one process."""
    t0 = time.perf_counter()
    save = f"{tmpdir}/shard_{exchange}_{backend}.pt"
    reports = launch_ranks(exchange, backend, save)
    launch_s = time.perf_counter() - t0
    want = SCALE_LAUNCHES_PER_TICK[exchange]
    for rep in reports:
        got = {k: rep["launches_per_tick"][k] for k in want}
        if got != want:
            raise AssertionError(f"shard {exchange} rank {rep['rank']}: launches a tick {got}, "
                                 f"expected {want}")
        if rep["exchange_bytes_per_tick"] != rep["model_bytes_per_tick"]:
            raise AssertionError(f"shard {exchange} rank {rep['rank']}: the exchange gathers "
                                 f"{rep['exchange_bytes_per_tick']} bytes a tick, the model "
                                 f"{rep['model_bytes_per_tick']}")
        prof = (rep.get("profile") or {}).get("kernel_device_us", {})
        log(f"[shard] {exchange} {backend} rank {rep['rank']} ({rep['device']}, R_local "
            f"{R_SCALE // SHARD_RANKS}): {rep['ms_per_tick']:.3f} ms/tick (host clock, "
            f"{SHARD_TICKS} eager ticks); launches a tick {got}; collective bytes a tick "
            f"{rep['collective_bytes_per_tick'] / 1e6:.3f} MB, of which the exchange's table "
            f"{rep['exchange_bytes_per_tick'] / 1e6:.3f} MB = the model's "
            f"{rep['model_bytes_per_tick'] / 1e6:.3f} MB; kernel device us per launch "
            f"(torch.profiler of one tick on rank 0): "
            + (", ".join(f"{k} {v:.3f}" for k, v in prof.items()) or "not recorded"))
    top = sorted(reports[0]["bytes_per_tick"].items(), key=lambda kv: -kv[1])
    log(f"[shard] {exchange}: rank 0's collective bytes a tick by call site: "
        + ", ".join(f"{k} {v / 1e6:.4f} MB" for k, v in top))
    saved = torch.load(save)
    compare = sharded_compare(torch, exchange, saved)
    del saved
    log(f"[shard] {exchange} {backend}: ranks started, ran and gathered in {launch_s:.1f} s")
    return {"reports": reports, "compare": compare}


def shard_phase(torch) -> dict:
    """Phase 11: (a) two gloo ranks on the card, R_SCALE robots, under
    "sender" and "receiver_compact"; (b) dryrun_multichip(2) over gloo;
    (c) (a) over nccl where there are two cards."""
    import tempfile

    from magics_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for exchange in ("sender", "receiver_compact"):
            out[exchange] = shard_exchange(torch, exchange, "gloo", tmpdir)
        t1 = time.perf_counter()
        dryrun_multichip(SHARD_RANKS, backend="gloo")
        log(f"[shard] dryrun_multichip({SHARD_RANKS}, backend='gloo') on the card: sender and "
            f"receiver_compact agree with one process (1e-5, 1e-4) in "
            f"{time.perf_counter() - t1:.1f} s")
        if torch.cuda.device_count() >= SHARD_RANKS:
            for exchange in ("sender", "receiver_compact"):
                shard_exchange(torch, exchange, "nccl", tmpdir)
        else:
            log(f"[shard] nccl: not run ({torch.cuda.device_count()} card)")
    log(f"[shard] phase 11 in {time.perf_counter() - t0:.1f} s ({SHARD_TICKS} ticks a run)")
    return out


# --------------------------------------------------------------------------
# phase 12: experiments and parity
# --------------------------------------------------------------------------

# The parity cases' slots, 10 internal + 10 external a tick under "sender"
PARITY_LAUNCHES_PER_TICK = {"internal_slot": 10, "variable_slot": 10, "interrobot_slot": 10,
                            "gather_rows": 20}
# The lanes case in float64 on the card's plain passes against the oracle:
# roundoff only (over its 80 ticks 4.6e-11 m for the port's tick and 4.8e-11
# for the JAX tick, both on the CPU), so 1e-6 m leaves four orders for
# another card's summation order and still fails a wrong term by orders more.
PARITY_F64_RMSE = 1e-6
# The tick of each parity case from which kernels_at holds every kernel
# against its plain version at the case's shapes (lanes K=5, V=13; circle
# K=7; junction K=5 with the tracking factor on), and of a 10-robot sweep
# row (K=9, V=21): each mid-crossing, with inter-robot factors live
# (interrobot_compare fails where none is)
PARITY_CHECK_TICK = {"lanes": 20, "circle": 15, "junction": 22}
ROW_CHECK_TICK = 30
# The sweeps phase 12 runs through run_experiment.main over the Circle
# Experiment's directory: 4 rows (10 and 50 robots, seeds 0 and 31), then 2
# rows of 10 robots at comms failure 0 and 0.7
SWEEP = ["--robots", "10:50:40", "--seeds", "0,31", "--max-time", "60"]
FAILURE_SWEEP = ["--robots", "10:10:1", "--seeds", "0", "--failure-rates", "0.0,0.7",
                 "--max-time", "60"]


def parity_phase(torch) -> dict:
    """(a) The parity harness's cases on the card against the numpy
    oracle's committed trajectories: lanes through the kernels (float32),
    RMSE within F13's 3e-3 m, completion equal, the degree held at 5; lanes
    in float64 on the plain passes within PARITY_F64_RMSE; circle (80
    ticks) and junction (60) through the kernels, completion within +-1 and
    each robot's completion tick within the harness's window of the
    oracle's (run_case asserts the harness's bounds). After each kernel
    run's counts are read, every kernel is held against its plain version
    at the case's shapes (kernels_at). Returns each kernel run's launches a
    tick."""
    from pathlib import Path

    from magics_tpu_torch.scripts import parity_rmse as P

    reference = P.load_reference(Path(__file__).resolve().parent / P.DEFAULT_REFERENCE)
    out = {}
    for name, dtype in (("lanes", torch.float32), ("lanes", torch.float64),
                        ("circle", torch.float32), ("junction", torch.float32)):
        ticks = P.case_ticks(name)
        reset_counts()
        t0 = time.perf_counter()
        rec = P.run_case(name, ticks, reference=reference, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        per_tick = {k: v / ticks for k, v in read_counts().items()}
        label = f"{name} {str(dtype).removeprefix('torch.')}"
        if dtype == torch.float32:
            if per_tick != {k: float(v) for k, v in PARITY_LAUNCHES_PER_TICK.items()}:
                raise AssertionError(f"(a) {label}: launches a tick {per_tick}")
            out[name] = per_tick
        elif per_tick["internal_slot"] or per_tick["variable_slot"]:
            raise AssertionError(f"(a) {label}: the slot kernels ran on a float64 state")
        elif rec["rmse_max_m"] > PARITY_F64_RMSE:
            raise AssertionError(f"(a) {label}: RMSE {rec['rmse_max_m']:.3e} m")
        jax64, jax32 = reference[f"{name}_jax_rmse"]
        log(f"[experiments] (a) {label}, {ticks} ticks on the card against the oracle: RMSE "
            f"(max over robots) {rec['rmse_max_m']:.3e} m, final divergence "
            f"{rec['divergence_curve_max_m'][-1]:.3e} m, completed {rec['completed_dense']} / "
            f"oracle {rec['completed_oracle']}, degree {rec['robots'] - 1} held; launches a "
            f"tick {per_tick}; {run_s:.2f} s (the JAX tick's RMSE on the CPU, recorded in the "
            f"reference: float64 {jax64:.3e}, float32 {jax32:.3e} m)")
        if dtype == torch.float32:
            make, factors, _, _ = P.CASES[name]
            params, state, sdf = P.build_case(*make(), factors=factors, dtype=dtype,
                                              device="cuda")
            state = P.trajectory(params, state, sdf, PARITY_CHECK_TICK[name])["state"]
            kernels_at(torch, state, params, sdf,
                       f"(a) {name} at tick {PARITY_CHECK_TICK[name]}")
    return out


def row_contract(done) -> dict:
    """A harness row against the experiment's contract (every robot
    completes, makespan < 60 s, no overflow) and its chunk graph's launches
    a tick against the sender workload's 50 / 10 / 10 / 20. Returns the
    launches a tick."""
    row, sim = done.row, done.sim
    if (row["completed"] != row["robots"] or row["makespan"] >= 60.0
            or row["nbr_overflow"] != 0 or row["grid_overflow"] != 0):
        raise AssertionError(f"(b) a row broke the experiment's contract: {row}")
    if sim.state.device.type != "cuda" or len(sim.graphs) != 1:
        raise AssertionError(f"(b) the row ran on {sim.state.device}, graphs {sorted(sim.graphs)}")
    (chunk, graph), = sim.graphs.items()
    per_tick = {k: v / chunk for k, v in graph.launches.items()}
    if per_tick != {k: float(v) for k, v in LAUNCHES_PER_TICK["sender"].items()}:
        raise AssertionError(f"(b) row {row['robots']} robots, seed {row['seed']}: launches a "
                             f"tick {per_tick}")
    t = done.times
    log(f"[experiments] (b) row: {row['robots']} robots, seed {row['seed']}"
        + (f", failure rate {row['failure_rate']}" if "failure_rate" in row else "")
        + f": {row['completed']}/{row['robots']} done at {row['makespan']:.1f} s, "
        f"{row['ticks']} ticks in {chunk}-tick graphs; capture {t['capture_s']:.2f} s, replay "
        f"{t['replay_s']:.2f} s (the rest of run), build {t['build_s']:.2f} s, export "
        f"{t['export_ms']:.1f} ms, analysis {t['analysis_ms']:.1f} ms; launches a tick "
        f"{per_tick}")
    return per_tick


def experiment_phase(torch, tmpdir) -> dict:
    """(b) run_experiment.main in this process over the Circle Experiment's
    directory (phase 10's writer): SWEEP's 4 rows, each to the contract at
    50 / 10 / 10 / 20 launches a tick, every kernel held against its plain
    version at a 10-robot row's shapes (kernels_at), the 50-robot seed-0
    row's export bit-equal to a direct Simulator run of the same scenario,
    seed and max time; then FAILURE_SWEEP's 2 rows, the failed-antenna
    share of the active robots after each tick (9(d)'s measure, with 1-tick
    chunks) of the 0.7 row within 0.05 of the rate."""
    import unittest.mock
    from pathlib import Path

    from magics_tpu_torch.config.loader import load_scenario
    from magics_tpu_torch.scripts import run_experiment as X
    from magics_tpu_torch.sim import simulator as S

    root = Path(tmpdir) / "scenarios"
    root.mkdir()
    circle_dir = write_scenario(root, circle_scenario(), circle_formation_doc(CIRCLE_ROBOTS, 50.0))
    rows = []

    def on_row(done):
        rows.append((done, row_contract(done)))

    out_dir = Path(tmpdir) / "sweep"
    reset_counts()
    t0 = time.perf_counter()
    code = X.main([circle_dir.name, "--scenarios-dir", str(root), "--out", str(out_dir), *SWEEP],
                  on_row=on_row)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = read_counts()
    summary = json.loads((out_dir / "summary.json").read_text())
    if code != 0 or len(rows) != 4 or [r["robots"] for r in summary] != [10, 10, 50, 50]:
        raise AssertionError(f"(b) the sweep: exit {code}, rows {summary}")
    if not all(launches.values()):
        raise AssertionError(f"(b) a kernel never launched in the sweep: {launches}")
    capture_s = sum(done.times["capture_s"] for done, _ in rows)
    log(f"[experiments] (b) run_experiment.main '{circle_dir.name}' {' '.join(SWEEP)}: "
        f"{len(rows)} rows in {sweep_s:.1f} s, capture {capture_s:.1f} s of it "
        f"({100 * capture_s / sweep_s:.1f}%); launches in the sweep {launches}")

    # every kernel at a 10-robot row's shapes, from its own scenario re-run
    # eagerly to mid-crossing, after the sweep's counts were read
    done = rows[0][0]
    done.sim.reset()
    done.sim.run(max_ticks=ROW_CHECK_TICK, chunk_ticks=SIM_CHUNK)    # a partial chunk: eager
    kernels_at(torch, done.sim.state, done.sim.params, done.sim.sdf,
               f"(b) {done.row['robots']}-robot seed-{done.row['seed']} row at tick "
               f"{ROW_CHECK_TICK}")

    cell = {key: None for key, _ in X.AXES} | {"robots": 50, "seed": 0}
    t0 = time.perf_counter()
    direct = S.Simulator(X.scenario_for(load_scenario(circle_dir), cell), seed=0,
                         max_sim_time=60.0, viz_log=False)
    direct.run()
    want = json.dumps(direct.export(), sort_keys=True)
    direct_s = time.perf_counter() - t0
    got = json.dumps(json.loads((out_dir / f"export_{X.tag(circle_dir.name, cell)}.json")
                                .read_text()), sort_keys=True)
    if got != want:
        raise AssertionError("(b) the 50-robot row's export differs from a direct Simulator run")
    log(f"[experiments] (b) the 50-robot seed-0 row's export is bit-equal to a direct "
        f"Simulator(sc, seed=0, max_sim_time=60.0).run() and export() ({direct_s:.1f} s)")
    del direct

    shares = []

    class Sampled(S.Simulator):
        """The harness's Simulator, run in 1-tick chunks, counting the
        active robots' failed antennas after each tick on the card."""

        def run(self, **kw):
            off = torch.zeros((), dtype=torch.int64, device=self.device)
            act = torch.zeros_like(off)

            def sample(state, _tick):
                off.add_((~state.antenna & state.active).sum())
                act.add_(state.active.sum())

            result = super().run(chunk_ticks=1, on_chunk=sample, **kw)
            shares.append((int(off), int(act)))
            return result

    failure_rows = []
    with unittest.mock.patch.object(S, "Simulator", Sampled):
        X.main([circle_dir.name, "--scenarios-dir", str(root), "--out",
                str(Path(tmpdir) / "failure"), *FAILURE_SWEEP],
               on_row=lambda done: failure_rows.append((done, row_contract(done))))
    (_, (off0, _)), (_, (off7, act7)) = zip(failure_rows, shares, strict=True)
    share = off7 / max(act7, 1)
    if off0 != 0 or abs(share - FAILURE_RATE) > 0.05:
        raise AssertionError(f"(b) failed shares {off0} and {share} at rates 0.0 and "
                             f"{FAILURE_RATE}")
    log(f"[experiments] (b) run_experiment.main {' '.join(FAILURE_SWEEP)}: failed-antenna share "
        f"of the active robots {share:.4f} over {act7} robot-ticks at rate {FAILURE_RATE}, 0 at "
        f"rate 0.0")
    per_row = [per_tick for _, per_tick in rows + failure_rows]
    return {"launches": launches, "launches_per_tick": per_row,
            "rows": [done.times | {"robots": done.row["robots"], "seed": done.row["seed"]}
                     for done, _ in rows]}


def experiments_phase(torch) -> dict:
    """Phase 12 (a) and (b)."""
    import tempfile

    t0 = time.perf_counter()
    parity = parity_phase(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        out = experiment_phase(torch, tmpdir)
    log(f"[experiments] phase 12 in {time.perf_counter() - t0:.1f} s")
    return {"parity": parity, **out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    device_phase(torch)
    build_phase()
    kernels = kernel_phase(torch, device)
    small_input_phase(torch, device)
    # the sender slice runs every kernel; its counts go in the kernels line
    launches, state, params, sdf, eager_ms = slice_phase(torch, "sender")
    # K3 once more, on the inputs the main path gives it after 100 ticks
    # (live factors); after the counts were read, so it adds no launch. Its
    # times there go in the kernels line: the kernel's work depends on the
    # data, and the synthetic check's (many more live factors) is logged above
    main_path = interrobot_check(torch, state, params, "sender slice after 100 ticks")
    kernels["interrobot_slot"] = {
        **main_path,
        "max_abs_err": max(kernels["interrobot_slot"]["max_abs_err"], main_path["max_abs_err"]),
    }
    sender_graph_ms = graph_phase(torch, "sender", state, params, sdf, eager_ms)
    del state
    _, state, params, sdf, eager_ms = slice_phase(torch, "receiver_compact")
    graph_phase(torch, "receiver_compact", state, params, sdf, eager_ms)
    del state
    grid_dense_phase(torch)
    scale = {exchange: scale_phase(torch, exchange) for exchange in ("receiver_compact", "sender")}
    sim = simulator_phase(torch, sender_graph_ms)
    surfaces = surfaces_phase(torch, sim)
    shard = shard_phase(torch)
    experiments = experiments_phase(torch)

    report = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": SOURCE[name],
                "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": kernels[name]["max_abs_err"],
                "ms": kernels[name]["ms"],
                "plain_ms": kernels[name]["plain_ms"],
                "bound_ms": kernels[name]["bound_ms"],
                "bound_by": kernels[name]["bound_by"],
                "library_ms": kernels[name]["library_ms"],
                "device_us": kernels[name]["device_us"],
                "device_us_warm": kernels[name]["device_us_warm"],
                "device_us_cold": kernels[name]["device_us_cold"],
                **{k: kernels[name][k] for k in ("library_device_us", "shapes")
                   if k in kernels[name]},
                "scale": {exchange: scale[exchange].get(name)
                          for exchange in scale},
                "simulator": {"launches": sim["launches"][name],
                              "launches_per_tick": sim["launches_per_tick"][name],
                              "device_us_circle_k49": sim["device_us"][name]},
                "cli": {"launches": surfaces["launches"][name],
                        "launches_per_tick": surfaces["launches_per_tick"][name]},
                "experiment": {
                    "launches": experiments["launches"][name],
                    "launches_per_tick_by_row": [row[name] for row in
                                                 experiments["launches_per_tick"]],
                    "parity_launches_per_tick": {case: per_tick[name] for case, per_tick
                                                 in experiments["parity"].items()},
                },
                "sharded": {
                    "ranks": SHARD_RANKS,
                    "launches_per_tick": {
                        exchange: [rep["launches_per_tick"][name]
                                   for rep in shard[exchange]["reports"]]
                        for exchange in shard},
                    "device_us_rank0": {
                        exchange: ((shard[exchange]["reports"][0].get("profile") or {})
                                   .get("kernel_device_us", {}).get(name))
                        for exchange in shard},
                },
            }
            for name in REPLACES
        ]
    }
    print(json.dumps(report))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

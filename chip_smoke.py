"""Smoke run of the PyTorch + CUDA port (magics_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc.
2. Build: compiles the slot kernels from csrc/ (kernels/build.py).
3. Kernels: each slot kernel against its plain PyTorch version on the card,
   at the bench shapes (R=1024, V=21, W=2, float32), on the hot dict of the
   bench scenario after a few ticks, with SDF taps from a non-trivial SDF:
   the internal slot with tracking on and off, and the variable slot. Prints
   errors, validity-mask flips and CUDA-event times of both.
4. Small input: 20 ticks of a converging 16-robot crossing through the
   kernels against the port's plain GBP passes on the card.
5. The slice: the bench.py workload (R=1024, 50 internal + 10 external
   slots per tick) through `tick.run_ticks`: 2 warm-up chunks of 20 ticks,
   then 3 timed chunks; asserts finite state, motion, no neighbour overflow,
   live connectivity and exactly 50 internal + 10 variable launches per
   tick; prints the metric line in bench.py's format.

The last two lines are a JSON object of per-kernel results and the JSON
status line `{"ok": true, "device": {...}}`. Nothing here imports JAX. The
script refuses to run without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

R_BENCH = 1024
CHUNK = 20
SOURCE = "magics_tpu_torch/kernels/csrc/gbp_slot.cu"
REPLACES = {
    "internal_slot": "magics_tpu/kernels/gbp_slot.py:838",
    "variable_slot": "magics_tpu/kernels/gbp_slot.py:802",
}
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
    from magics_tpu_torch.kernels.gbp_slot import _lib

    t0 = time.perf_counter()
    _lib()
    log(f"[build] gbp_slot built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({build.library_path('gbp_slot').name})")
    for line in build.ptxas_report("gbp_slot").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] ptxas: {line.strip()}")


def bench_scenario(torch, device):
    """The bench.py workload, built by the port."""
    from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

    speed = 15.0
    return build_scenario(
        circle_formation(R_BENCH, circle_radius=800.0, target_speed=speed),
        target_speed=speed,
        planning_horizon=5.0,
        hz=10.0,
        comms_radius=50.0,
        internal=50,
        external=10,
        schedule=ScheduleKind.INTERLEAVE_EVENLY,
        n_slots=32,
        world=(2000.0, 2000.0),
        sdf=np.ones((128, 128)),
        dtype=torch.float32,
        device=device,
        despawn_on_final_waypoint=False,
        use_pallas=True,
        tracking_enabled=False,
        ext_exchange="receiver_compact",
    )


def obstacle_sdf(n: int = 128) -> np.ndarray:
    """A non-trivial SDF image in [0, 1]: a smooth periodic field of
    obstacles, quantised to 1/255 like magics_tpu env.sdf.env_to_sdf."""
    y, x = np.mgrid[0:n, 0:n] / n
    field = 0.5 + 0.5 * np.sin(2 * np.pi * 5 * x) * np.cos(2 * np.pi * 3 * y + 1.0)
    return np.round(field * 255.0) / 255.0


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


def compare(torch, name, got: dict, want: dict) -> float:
    """Field-by-field check of kernel outputs against the plain version.
    Returns the largest absolute belief_mean error; raises past RTOL or past
    MAX_FLIP_SHARE validity-mask flips."""
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
    if bad or flips > MAX_FLIP_SHARE * got["belief_mean"][0].numel():
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


def kernel_phase(torch, device) -> dict:
    from dataclasses import replace

    from magics_tpu_torch.graph import factors as F
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import gbp_slot as G
    from magics_tpu_torch.kernels import hot as HOT

    params, state, sdf = bench_scenario(torch, device)
    state = T.run_ticks(state, sdf, params, 3)
    world = (params.world_width, params.world_height)
    sdf_obs = torch.as_tensor(obstacle_sdf(), device=device, dtype=torch.float32)
    sp = replace(
        HOT.slot_params(params),
        obstacle_delta=F.obstacle_delta(tuple(sdf_obs.shape), world),
    )
    h = HOT.to_hot(state, params)
    gate = (state.active & (state.mission_active | state.completed)).float()[None].contiguous()
    taps = F.obstacle_taps(h["obs_v2f_mu"].movedim(0, -1), sdf_obs, world)
    ext = HOT._ext_sum_hot(state)
    slot_in = {
        **h, "gate": gate, "tgate": gate,
        "obs_h0": taps[0].contiguous(), "obs_hx": taps[1].contiguous(),
        "obs_hy": taps[2].contiguous(),
        "ext_sum_eta": ext[0], "ext_sum_lam": ext[1],
    }
    nonzero_obs = float((taps[1] != taps[0]).float().mean())
    log(f"[kernels] bench hot dict after 3 ticks: R={state.n_robots} V={params.n_vars} "
        f"W={params.max_waypoints}; SDF taps with a gradient: {nonzero_obs:.1%}")

    results = {}
    errs = []
    for trk in (True, False):
        spt = replace(sp, tracking_enabled=trk)
        got = G.internal_slot(slot_in, spt)
        want = G.internal_slot_reference(slot_in, spt)
        torch.cuda.synchronize()
        errs.append(compare(torch, f"internal_slot tracking={'on' if trk else 'off'}", got, want))
    ms = cuda_ms(torch, lambda: G.internal_slot(slot_in, sp))
    plain_ms = cuda_ms(torch, lambda: G.internal_slot_reference(slot_in, sp))
    log(f"[kernels] internal_slot (bench flags): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(CUDA events, median of 20)")
    results["internal_slot"] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}

    var_in = {name: slot_in[name] for name in G._VAR_IN_FIELDS}
    got = G.variable_slot(var_in, sp)
    want = G.variable_slot_reference(var_in, sp)
    torch.cuda.synchronize()
    err = compare(torch, "variable_slot", got, want)
    ms = cuda_ms(torch, lambda: G.variable_slot(var_in, sp))
    plain_ms = cuda_ms(torch, lambda: G.variable_slot_reference(var_in, sp))
    log(f"[kernels] variable_slot: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(CUDA events, median of 20)")
    results["variable_slot"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def small_input_phase(torch, device) -> None:
    """The kernel path against the port's plain GBP passes, 20 ticks of a
    converging crossing with live inter-robot factors (the tests' scenario)."""
    from dataclasses import replace

    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

    specs = circle_formation(16, circle_radius=20.0, target_speed=15.0)
    for i, s in enumerate(specs):  # break the circle's exact distance ties
        s.start[:2] *= 1.0 + 0.01 * i
        s.waypoints[0, :2] *= 1.0 + 0.01 * i
    params, state, sdf = build_scenario(
        specs, target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
        internal=6, external=3, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=torch.float32,
        device=device, despawn_on_final_waypoint=False, tracking_enabled=False,
        ext_exchange="receiver_compact",
    )
    plain = T.run_ticks(state, sdf, params, 20)
    kern = T.run_ticks(state, sdf, replace(params, use_pallas=True), 20)
    drift = float((plain.pos - kern.pos).abs().max())
    moved = float((kern.pos - state.pos).abs().max())
    inbox = float(kern.ext_inbox.abs().sum())
    log(f"[small] R=16, 20 ticks: kernel vs plain passes max |dpos| {drift:.3e} m; "
        f"moved {moved:.2f} m; |ext_inbox| {inbox:.3e}")
    if not (drift < SMALL_DRIFT_M and moved > 1.0 and inbox > 0.0):
        raise AssertionError("kernel path does not track the plain path on the small input")


def slice_phase(torch, device) -> dict:
    from magics_tpu_torch.graph import tick as T
    from magics_tpu_torch.kernels import gbp_slot as G

    params, state, sdf = bench_scenario(torch, device)
    V, R = params.n_vars, state.n_robots
    start_pos = state.pos.clone()
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e)

    t0 = time.perf_counter()
    for _ in range(2):  # warm-up: let the swarm reach steady state
        state = T.run_ticks(state, sdf, params, CHUNK)
    torch.cuda.synchronize()
    log(f"[slice] warm-up 2 x {CHUNK} ticks in {time.perf_counter() - t0:.2f} s")

    reps = 3
    G.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = T.run_ticks(state, sdf, params, CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(G.launch_counts)
    ticks = reps * CHUNK

    for name, x in vars(state).items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite values in {name}")
    moved = float((state.pos - start_pos).abs().max())
    overflow = int(state.nbr_overflow)
    mean_degree = float(state.nbr_mask.sum()) / R
    if moved <= 1.0:
        raise AssertionError(f"robots did not move ({moved} m)")
    if overflow != 0:
        raise AssertionError(f"nbr_overflow {overflow}")
    if mean_degree <= 0.0:
        raise AssertionError("no inter-robot connectivity")
    if launches != {"internal_slot": n_int * ticks, "variable_slot": n_ext * ticks}:
        raise AssertionError(f"launches {launches} for {ticks} ticks of {n_int}i+{n_ext}e")

    ticks_per_s = ticks / dt
    per_factor = 2 * (V - 1) + (V - 2)   # dynamic + obstacle (tracking off)
    msgs_per_tick = R * (
        n_int * (2 * per_factor + mean_degree * (V - 1))
        + n_ext * (2 * mean_degree * (V - 1))
    )
    line = {
        "metric": "gbp_message_updates_per_s",
        "value": round(msgs_per_tick * ticks_per_s),
        "unit": (
            f"messages/s (R={R}, V={V}, {n_int}i+{n_ext}e per tick, "
            f"mean_degree={mean_degree:.1f}, nbr_overflow={overflow})"
        ),
        "vs_baseline": round(ticks_per_s / params.hz, 3),
    }
    log(f"[slice] {ticks} ticks in {dt:.3f} s: {1e3 * dt / ticks:.3f} ms/tick; "
        f"moved {moved:.1f} m; launches {launches}")
    log(json.dumps(line))
    return launches


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
    launches = slice_phase(torch, device)

    report = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": kernels[name]["max_abs_err"],
                "ms": kernels[name]["ms"],
                "plain_ms": kernels[name]["plain_ms"],
            }
            for name in ("internal_slot", "variable_slot")
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

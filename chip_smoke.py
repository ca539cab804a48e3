"""Smoke run of the PyTorch + CUDA port (magics_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc.
2. Build: compiles the three kernel libraries from csrc/ at once
   (kernels/build.py) and prints their ptxas lines.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the bench shapes (R=1024, K=32, V=21, W=2, float32). The slot kernels on
   the hot dict of the bench scenario after a few ticks, with SDF taps from
   a non-trivial SDF: the internal slot with tracking on and off, and the
   variable slot. The inter-robot message table on a sender-mode bench
   state after 3 ticks with some cavities unseeded and the peers' positions
   moved into range. The row gather, bit for bit, at its four call sites'
   shapes. Prints errors, flips and CUDA-event times of both.
4. Small input: 20 ticks of a converging 16-robot crossing through the
   kernels against the port's plain GBP passes on the card, for each of
   the three inter-robot exchanges.
5. The slices: the bench.py workload (R=1024, 50 internal + 10 external
   slots per tick) through `tick.run_ticks`, first with the "sender"
   exchange, then with "receiver_compact": 2 warm-up chunks of 20 ticks,
   then 3 timed chunks each; asserts finite state, motion, no neighbour
   overflow, live connectivity and the exact kernel launches per tick;
   prints a metric line in bench.py's format for each. After the sender
   slice, the message table against its plain version once more, on the
   slice's own final state (live factors, some cavities unseeded).

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
# are knife edges too: at most this share of its entries may be zero in one
# version and not in the other. The rest are held to RTOL of each message's
# own scale, max(|plain| over (gx, gy, t, s), 1).
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


def bench_scenario(torch, device, exchange="receiver_compact"):
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
        ext_exchange=exchange,
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

    params, state, sdf = bench_scenario(torch, device, "sender")
    state = T.run_ticks(state, sdf, params, 3)
    results["interrobot_slot"] = interrobot_check(torch, state, params, "synthetic", timed=True)
    results["gather_rows"] = gather_check(torch, state)
    return results


def interrobot_check(torch, state, params, label: str, timed: bool = False) -> dict:
    """The inter-robot message table against its plain version on a
    sender-mode bench state. The seeded flags of every third robot are
    cleared on every other variable (tests/test_ir_slot.py), so the
    empty-cavity guard runs. With label "synthetic" (the state after 3
    ticks, when no pair of the bench ring, 4.9 m apart, is within the 4.4 m
    safety distance yet) each external position is moved to a seeded random
    point within 1.2 safety distances of its internal snapshot, so the live
    path, the skip and the guards all run on many entries; otherwise the
    state's own inputs are taken as the main path gives them."""
    from magics_tpu_torch.kernels import ir_slot as IR

    inputs = IR.sender_inputs(state, params)
    R, K, V1 = inputs["seeded"].shape
    seeded = inputs["seeded"].clone()
    seeded[::3, :, ::2] = False
    inputs["seeded"] = seeded
    if label == "synthetic":
        g = torch.Generator(device=state.device).manual_seed(0)
        dist = 1.2 * inputs["safety"][:, None, None] * torch.rand(
            (R, K, V1), generator=g, device=state.device)
        angle = 2 * np.pi * torch.rand((R, K, V1), generator=g, device=state.device)
        offset = torch.stack([dist * torch.cos(angle), dist * torch.sin(angle)], dim=-1)
        inputs["p_ext"] = (state.snap_mu[:, None, 1:, :2] + offset).contiguous()
    sigma = params.sigma_factor_interrobot

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
        f"messages of {n} ({int((~seeded).sum())} cavities unseeded); error over own scale "
        f"{rel:.3e}, max |err| {abs_err:.3e}; zero-pattern flips {flips} of {n}")
    if not bool(live_want.any()) or rel > RTOL or flips > MAX_FLIP_SHARE * n:
        raise AssertionError(f"interrobot_slot {label}: rel {rel} (rtol {RTOL}), flips {flips}")
    if not timed:
        return {"max_abs_err": abs_err}
    ms = cuda_ms(torch, lambda: IR.interrobot_slot(**inputs, sigma=sigma))
    plain_ms = cuda_ms(torch, lambda: IR.interrobot_slot_reference(**inputs, sigma=sigma))
    log(f"[kernels] interrobot_slot: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(CUDA events, median of 20)")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def gather_check(torch, state) -> dict:
    """The row gather against `index_select`, bit for bit, at its call
    sites' bench shapes, with the state's own indexes and masks and seeded
    random tables: the sender's delivery of the peers' outboxes [R*K, V1*4],
    its response gather of the peers' positions [R, V1*2], the receiver's
    gather of the peers' snapshot packs [R, V1*24] and receiver_compact's
    gather of the peers' compact tables [R, V1*8]."""
    from magics_tpu_torch.kernels import layout as L

    R, K = state.nbr_idx.shape
    V1 = state.snap_mu.shape[1] - 1
    src = state.nbr_idx.clamp(0, R - 1).long()
    back = state.nbr_back.clamp(0, K - 1).long()
    mask = state.nbr_mask.reshape(-1)
    g = torch.Generator(device=state.device).manual_seed(1)

    def table(n, m):
        return torch.randn((n, m), generator=g, device=state.device)

    sites = {
        "sender delivery": (table(R * K, V1 * 4), (src * K + back).reshape(-1), mask),
        "sender response": (table(R, V1 * 2), src.reshape(-1), mask),
        "receiver pack": (table(R, V1 * 24), src.reshape(-1), None),
        "receiver_compact table": (table(R, V1 * 8), src.reshape(-1), None),
    }
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for site, (tab, idx, m) in sites.items():
        got = L.gather_rows(tab, idx, m)
        want = L.gather_rows_reference(tab, idx, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows {site}: {int((got != want).sum())} entries differ")
        ms = cuda_ms(torch, lambda: L.gather_rows(tab, idx, m))
        plain_ms = cuda_ms(torch, lambda: L.gather_rows_reference(tab, idx, m))
        log(f"[kernels] gather_rows {site} [{tab.shape[0]}, {tab.shape[1]}] -> "
            f"[{idx.shape[0]}, {tab.shape[1]}] {'masked' if m is not None else 'unmasked'}: "
            f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(CUDA events, median of 20)")
        if site == "sender delivery":   # the largest, reported in the kernels line
            out.update(ms=ms, plain_ms=plain_ms)
    return out


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
        plain = T.run_ticks(state, sdf, params, 20)
        kern = T.run_ticks(state, sdf, replace(params, use_pallas=True), 20)
        drift = float((plain.pos - kern.pos).abs().max())
        moved = float((kern.pos - state.pos).abs().max())
        inbox = float(kern.ext_inbox.abs().sum())
        log(f"[small] {exchange}, R=16, 20 ticks: kernel vs plain passes max |dpos| "
            f"{drift:.3e} m; moved {moved:.2f} m; |ext_inbox| {inbox:.3e}")
        if not (drift < SMALL_DRIFT_M and moved > 1.0 and inbox > 0.0):
            raise AssertionError(
                f"{exchange}: kernel path does not track the plain path on the small input")


def slice_phase(torch, device, exchange: str) -> dict:
    from magics_tpu_torch.graph import tick as T

    params, state, sdf = bench_scenario(torch, device, exchange)
    V, R = params.n_vars, state.n_robots
    start_pos = state.pos.clone()
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e)

    t0 = time.perf_counter()
    for _ in range(2):  # warm-up: let the swarm reach steady state
        state = T.run_ticks(state, sdf, params, CHUNK)
    torch.cuda.synchronize()
    log(f"[slice] {exchange}: warm-up 2 x {CHUNK} ticks in {time.perf_counter() - t0:.2f} s")

    reps = 3
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = T.run_ticks(state, sdf, params, CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
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
    expected = {name: n * ticks for name, n in LAUNCHES_PER_TICK[exchange].items()}
    if launches != expected:
        raise AssertionError(f"{exchange}: launches {launches} for {ticks} ticks, "
                             f"expected {expected}")

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
            + ("ext=sender, " if exchange == "sender" else "")
            + f"mean_degree={mean_degree:.1f}, nbr_overflow={overflow})"
        ),
        "vs_baseline": round(ticks_per_s / params.hz, 3),
    }
    live = int((state.ext_inbox != 0).any(dim=-1).sum())
    log(f"[slice] {exchange}: {ticks} ticks in {dt:.3f} s: {1e3 * dt / ticks:.3f} ms/tick; "
        f"moved {moved:.1f} m; live inbox messages at the end {live}; launches {launches}")
    log(json.dumps(line))
    return launches, state, params


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
    launches, state, params = slice_phase(torch, device, "sender")
    # K3 once more, on the inputs the main path gives it after 100 ticks
    # (live factors); after the counts were read, so it adds no launch
    main_path = interrobot_check(torch, state, params, "sender slice after 100 ticks")
    kernels["interrobot_slot"]["max_abs_err"] = max(
        kernels["interrobot_slot"]["max_abs_err"], main_path["max_abs_err"])
    del state
    slice_phase(torch, device, "receiver_compact")

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

"""Device-side measurements of the port on an NVIDIA GPU, by torch.profiler,
and host timers around the port's functions.

Used by chip_smoke.py and scripts/torch_tick_compare.py. It imports nothing
but torch, so the comparison script can load this file by path beside
another checkout's package. Every function here needs a CUDA device: the
profiler then records the kernels' own device time, which CUDA events
around a wrapper call (host work included) do not give.
"""

from __future__ import annotations

import time

import torch


def _device_time_us(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    return float(t if t is not None else evt.cuda_time_total)


def _is_device_event(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def profile(fn, attempts: int = 3, required: bool = True) -> dict | None:
    """Run `fn()` under torch.profiler (host and device) and return
    {"launches": cudaLaunchKernel calls, "device_us": device time of every
    kernel, copy and fill, "kernels": {name: [count, device us]}}. A window
    in which the profiler recorded no device activity at all (it happens
    now and then, and a CUDA graph's replay may not show its kernels) is
    run again, up to `attempts` times; `fn` must be safe to repeat. After
    that it raises, or with `required` False returns None."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches, device_us, kernels = 0, 0.0, {}
        for evt in prof.key_averages():
            if evt.key.startswith("cudaLaunchKernel"):
                launches += evt.count
            elif _is_device_event(evt):
                us = _device_time_us(evt)
                device_us += us
                kernels[evt.key] = [evt.count, us]
        if device_us > 0.0:
            return {"launches": launches, "device_us": device_us, "kernels": kernels}
    if not required:
        return None
    raise RuntimeError(f"torch.profiler recorded no device time in {attempts} windows")


#: bytes written between launches to push a kernel's inputs out of the
#: H100's 50 MB L2 cache
L2_FLUSH_BYTES = 64 << 20


def _profile_calls(fn, reps: int, cold: bool) -> dict:
    """The profile's kernels over `reps` calls of `fn` (after one call to
    warm up), with `cold` each after a 64 MB fill that evicts the inputs
    from L2."""
    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None

    def calls():
        for _ in range(reps):
            if cold:
                flush.zero_()
            fn()

    return profile(calls)["kernels"]


def kernel_device_us(fn, kernel: str, reps: int = 20, cold: bool = False) -> float:
    """Device time per launch of the kernels whose name contains `kernel`,
    over `reps` calls of `fn` (after one call to warm up): the mean over the
    launches the profiler recorded (it may miss one at the window's edge).
    With `cold`, a 64 MB fill before each call evicts the inputs from L2,
    for a kernel whose caller finds them cold."""
    hits = [(n, us) for name, (n, us) in _profile_calls(fn, reps, cold).items()
            if kernel in name]
    count = sum(n for n, _ in hits)
    if count == 0:
        raise RuntimeError(f"{kernel}: no launch profiled in {reps} calls")
    return sum(us for _, us in hits) / count


def call_device_us(fn, reps: int = 20) -> tuple[float, float, list[str]]:
    """Device time per call of `fn`, whatever kernels it launches (a library
    call's, whose names this code does not choose): in repeated calls, and
    with L2 flushed before each call, counting there only the kernels of
    the repeated calls (not the fill's). Each is the kernels' device time
    over the calls the profiler recorded (the launches of the most launched
    kernel). Returns both with the kernels' names."""
    warm = _profile_calls(fn, reps, False)
    cold = _profile_calls(fn, reps, True)

    def per_call(kernels: dict) -> float:
        hits = [v for name, v in kernels.items() if name in warm]
        if not hits:
            raise RuntimeError(f"no kernel of the call profiled in {reps} calls")
        return sum(us for _, us in hits) / max(n for n, _ in hits)

    return per_call(warm), per_call(cold), sorted(warm)


def host_timers(targets, sync: bool):
    """Wrap each (module, name) of `targets` with a host timer, where the
    module has that name; with `sync` each call is bracketed by
    torch.cuda.synchronize(), so that the time is the call's own host and
    device work. Returns the records {name: [calls, seconds]} and a function
    that restores the originals."""
    records, saved = {}, []
    for module, name in targets:
        if not hasattr(module, name):
            continue
        fn = getattr(module, name)
        records[name] = [0, 0.0]

        def timed(*args, _fn=fn, _rec=records[name], **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            _rec[0] += 1
            _rec[1] += time.perf_counter() - t0
            return out

        saved.append((module, name, fn))
        setattr(module, name, timed)

    def restore():
        for module, name, fn in saved:
            setattr(module, name, fn)

    return records, restore

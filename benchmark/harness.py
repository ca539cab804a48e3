"""What every cell of the benchmark shares: the files found by name, the
card's description, the spans the benchmark's own files put around calls
into the program, the device trace and its reduction, the checks of
`correct`, and the result line.

Nothing here imports JAX or the JAX package, and nothing imports the
program (magics_tpu_torch) at module level: the drivers do, inside their
set-up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "magics_tpu")

#: H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bandwidth and float32
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# --------------------------------------------------------------------------
# files found by name
# --------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with what it names: its
    configuration file, its traffic file and its own data file."""

    name: str
    chips: int
    config: dict
    traffic: dict
    data: dict
    end_to_end: list
    per_layer: list


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(
        name=name, chips=entry["chips"],
        config=load_json(root / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        data=load_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def load_module(path: Path):
    """Import a file of the benchmark by its path (metric readers and
    drivers are found by name, and a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    return load_module(BENCH / "drivers" / f"{kind}.py")


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py")


# --------------------------------------------------------------------------
# the process, the card
# --------------------------------------------------------------------------

def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    stat = Path("/proc/self/stat").read_text()
    start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"
    return out.strip().splitlines()[0]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

class Spans:
    """Host spans the benchmark puts around calls into the program. Each
    span adds its seconds to its name's total; while `record` is on, its
    interval (wall-clock ns, the profiler's clock) is kept for naming idle
    gaps."""

    def __init__(self) -> None:
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.intervals: list[tuple[str, int, int]] = []
        self.record = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
            self.count[name] = self.count.get(name, 0) + 1
            if self.record:
                self.intervals.append((name, w0, time.time_ns()))

    def wrap(self, obj, attr: str, name: str, before=None) -> None:
        """Replace `obj.attr` by a call to it inside the span `name`;
        `before()` runs first, outside the span."""
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            if before is not None:
                before()
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, wrapped)


# --------------------------------------------------------------------------
# the device trace
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """The device operations of one traced stretch: (name, start ns, end
    ns, kind) with kind "kernel" or "copy", and the stretch's host length."""

    ops: list
    window_s: float
    start_ns: int
    end_ns: int

    @property
    def kernels(self) -> list:
        return [op for op in self.ops if op[3] == "kernel"]

    def busy_s(self, kinds=("kernel", "copy")) -> float:
        """Seconds in which at least one operation of `kinds` ran: the
        union of their intervals."""
        busy, end = 0, None
        for _, s, e, _k in sorted((op for op in self.ops if op[3] in kinds), key=lambda op: op[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        """Stretches of the window in which no operation ran."""
        gaps, cursor = [], self.start_ns
        for _, s, e, _ in sorted(self.ops, key=lambda op: op[1]):
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if self.end_ns > cursor:
            gaps.append((cursor, self.end_ns))
        return gaps


def _op_kind(event) -> str | None:
    if str(event.device_type()).rsplit(".", 1)[-1] != "CUDA":
        return None
    kind = ""
    try:
        kind = str(event.activity_type()).lower()
    except (AttributeError, RuntimeError):
        pass
    name = event.name()
    if "memcpy" in kind or "memset" in kind or name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "kernel"


@contextlib.contextmanager
def device_trace(out: list, spans: Spans | None = None):
    """Trace the device (torch.profiler, CUDA activity only) over the block,
    synchronised at both ends; appends a `Trace` to `out`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0, w0 = time.perf_counter(), time.time_ns()
        if spans is not None:
            spans.record = True
        try:
            yield
        finally:
            torch.cuda.synchronize()
            t1, w1 = time.perf_counter(), time.time_ns()
            if spans is not None:
                spans.record = False
    ops = []
    for event in prof.profiler.kineto_results.events():
        kind = _op_kind(event)
        if kind is not None:
            s = event.start_ns()
            ops.append((event.name(), s, s + event.duration_ns(), kind))
    out.append(Trace(ops=ops, window_s=t1 - t0, start_ns=w0, end_ns=w1))


def device_ops(trace: Trace, top: int = 10) -> list:
    """The device operations that took most time, [name, seconds]."""
    total: dict[str, float] = {}
    for name, s, e, _ in trace.ops:
        total[name] = total.get(name, 0.0) + (e - s) / 1e9
    return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:top]


def idle_gaps(trace: Trace, spans: Spans, top: int = 10) -> list:
    """The longest idle gaps, [what the host was doing, seconds]: the
    innermost benchmark span around the gap's middle, else "host"."""
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        inside = [iv for iv in spans.intervals if iv[1] <= mid <= iv[2]]
        name = min(inside, key=lambda iv: iv[2] - iv[1])[0] if inside else "host"
        named.append([name, (e - s) / 1e9])
    return named


def kernel_time(trace: Trace, names) -> tuple[float, int]:
    """Seconds and launches of the kernels whose name holds one of `names`."""
    hits = [(e - s) for n, s, e, k in trace.ops if k == "kernel" and any(x in n for x in names)]
    return sum(hits) / 1e9, len(hits)


# --------------------------------------------------------------------------
# checks and the result
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """One number compared, its limit, and whether it passed (value <=
    limit; a number that could not be read fails)."""

    name: str
    value: float | None
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver's window and check give the harness."""

    attempted: int
    failed: int
    end_to_end: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    # the lower-precision control's numbers under the same limits, read
    # only where the run was asked for them (benchmark/control.py)
    control: list = dataclasses.field(default_factory=list)
    # for the per-layer readers
    traces: dict = dataclasses.field(default_factory=dict)   # name -> Trace
    stats: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)


def device_info(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def correct(checks: list) -> bool:
    """A run is correct where it compared something and every number
    compared is within its limit."""
    return bool(checks) and all(c.ok for c in checks)


def result_line(outcome: Outcome, metrics: dict, device: dict, breakdown=None) -> str:
    line = {"correct": correct(outcome.checks), "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return json.dumps(line)


def print_checks(checks: list) -> None:
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

class Context:
    """One run of one cell: what the traffic's loop is given, and what it hands
    back to the harness besides its Outcome (the set-up time and the memory
    peak, each read at its moment)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", control: bool = False) -> None:
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        #: also read the TF32 control beside the program (benchmark/control.py)
        self.control = control
        self.spans = Spans()
        self.setup_s: float | None = None
        self.memory_peak: int = 0
        self._undo: list = []

    @property
    def cuda(self) -> bool:
        return self.device != "cpu"

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def open_window(self) -> float:
        """Mark the end of set-up; returns the window's end (perf_counter)."""
        self.sync()
        self.setup_s = process_age_s()
        return time.perf_counter() + self.seconds

    def close_window(self) -> None:
        """Read the memory peak: before the reference runs."""
        self.sync()
        if self.cuda:
            import torch

            self.memory_peak = torch.cuda.max_memory_allocated()

    def wrap(self, obj, attr: str, name: str, before=None) -> None:
        """A span around `obj.attr` for this run (undone by `restore`)."""
        inner = getattr(obj, attr)
        self.spans.wrap(obj, attr, name, before)
        self._undo.append((obj, attr, inner))

    def patch(self, obj, attr: str, value) -> None:
        """Set `obj.attr` for this run (undone by `restore`)."""
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def restore(self) -> None:
        for obj, attr, inner in reversed(self._undo):
            setattr(obj, attr, inner)
        self._undo.clear()

    def rng(self, purpose: str):
        """A numpy generator drawn from the seed for one purpose."""
        import numpy as np

        return np.random.default_rng([self.seed, sum(map(ord, purpose))])


# --------------------------------------------------------------------------
# what the per-layer readers share
# --------------------------------------------------------------------------

def idle_share(trace: Trace | None) -> float | None:
    """% of the traced time in which no kernel ran."""
    if trace is None or not trace.kernels or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(kinds=("kernel",)) / trace.window_s)


def roofline_share(out, operation: str, kernels) -> float | None:
    """% of the least time of one `operation` (stats["slot_work"]: bytes
    and operations at the cell's state) over the mean device time of its
    launches in the profiled replay."""
    trace, work = out.traces.get("replay"), out.stats.get("slot_work")
    if trace is None or not work or operation not in work:
        return None
    seconds, launches = kernel_time(trace, kernels)
    if not launches:
        return None
    from benchmark.rooflines import least_seconds

    least, bound = least_seconds(*work[operation])
    share = 100.0 * least / (seconds / launches)
    log(f"[roofline] {operation}: {work[operation][0]} bytes, {work[operation][1]} operations, "
        f"least {1e6 * least:.3f} us ({bound}), measured {1e6 * seconds / launches:.3f} us a "
        f"launch over {launches}: {share:.3f}% ({card()})")
    return share

"""The port's own measurements: its host spans, the stage maps of its
captured CUDA graphs, and device-side measurements on an NVIDIA GPU by
torch.profiler with host timers around the port's functions.

**Spans.** `with span("sim.chunk"):` (or `@span("sim.run")` on a function)
adds the block's seconds and one call to that name's totals (`span_totals`),
always, at the cost of two clock reads and a dict update. While a
torch.profiler session is active it also keeps the block's interval on
`time.time_ns()`, the clock of the profiler's device timestamps;
`intervals(start_ns, end_ns)` reads them. A span emits no profiler range
(`record_function`) unless `annotate()` is on, as the CLI's `--profile`
turns it on: a CUDA-only trace would count such a range as a device
operation.

**Stage maps.** While `compile_ticks` captures a chunk, `stage(name)` marks
where each stage of the tick begins (graph/tick.py:step, graph/gbp.py);
the mark reads the capture's current node and adds nothing to the graph.
The capture's `StageMap` gives each stage's first device operation, in the
order a replay runs them; `stage_device_ms` splits a profiled replay's
device time by it. `newest_stage_map()` is the map of the newest capture.
Below the stages, `part(name, *size)` marks where a part of a stage begins
and the part before it ends (`part(None)` only ends it): the map keeps
each part's operations, and the sizes it ran at, apart from the stages,
and `part_device_ms` splits a replay by them. Outside a capture a part
mark costs what a stage mark costs.

The profiler helpers are used by chip_smoke.py and
scripts/torch_tick_compare.py. This file imports nothing but torch at its
top, so the comparison script can load it by path beside another
checkout's package. Each profiler helper needs a CUDA device: the profiler
then records the kernels' own device time, which CUDA events around a
wrapper call (host work included) do not give.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import dataclasses
import time
import warnings

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


# --------------------------------------------------------------------------
# the program's spans
# --------------------------------------------------------------------------

#: {name: [calls, nanoseconds]} of every span since `reset_spans()`
span_totals: dict[str, list] = {}
#: (name, start ns, end ns) of the spans that ended while a profiler ran
_intervals: list[tuple[str, int, int]] = []
_annotating = False
_profiler_enabled = torch._C._autograd._profiler_enabled


class span(contextlib.ContextDecorator):
    """A host span of the program, as a context manager or a decorator (see
    the module docstring). Spans nest; the innermost open one names what
    the host is doing."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def _recreate_cm(self):
        return span(self.name)

    def __enter__(self):
        if _annotating:
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        total = span_totals.get(self.name)
        if total is None:
            span_totals[self.name] = [1, t1 - self._t0]
        else:
            total[0] += 1
            total[1] += t1 - self._t0
        if _profiler_enabled():
            _intervals.append((self.name, self._t0, t1))
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def intervals(start_ns: int, end_ns: int) -> list[tuple[str, int, int]]:
    """The spans kept while a profiler ran that overlap [start_ns, end_ns],
    clipped to it, as (name, start ns, end ns) in the order they ended (an
    inner span before the one around it)."""
    return [(n, max(s, start_ns), min(e, end_ns)) for n, s, e in _intervals
            if s < end_ns and e > start_ns]


def reset_spans() -> None:
    """Forget every span's totals and intervals."""
    span_totals.clear()
    _intervals.clear()


@contextlib.contextmanager
def annotate():
    """Within the block every span is also a profiler range
    (`record_function`), so that a trace shows the spans beside the
    kernels they launched."""
    global _annotating
    before, _annotating = _annotating, True
    try:
        yield
    finally:
        _annotating = before


# --------------------------------------------------------------------------
# the stage map of a captured graph
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Part:
    """A part of a stage in a captured CUDA graph: its device operations
    `start` to `end` (not included), and the sizes it ran at."""

    name: str
    start: int
    end: int
    size: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class StageMap:
    """The stages of a captured CUDA graph in the order a replay runs them:
    stage `names[i]` begins at device operation `starts[i]` (kernel, copy or
    fill, counted from 0) and ends where the next begins; `ops` counts the
    graph's nodes, each a device operation of a replay. A name recurs (each
    tick's systems, each run of GBP slots of one kind). `parts`, the parts
    marked inside the stages in the order they ran, is a second map, which
    the split by stage does not read."""

    names: tuple[str, ...]
    starts: tuple[int, ...]
    ops: int
    parts: tuple[Part, ...] = ()


_recorder = None
_newest_map: StageMap | None = None


def stage(name: str) -> None:
    """Mark the start of stage `name` in the graph being captured under a
    `StageRecorder`; nothing elsewhere."""
    if _recorder is not None:
        _recorder.mark(name)


def part(name: str | None, *size: int) -> None:
    """Mark where part `name` of the open stage begins, ending the part
    before it (`None` only ends it), with the sizes it runs at, in the
    graph being captured under a `StageRecorder`; nothing elsewhere."""
    if _recorder is not None:
        _recorder.mark_part(name, size)


def newest_stage_map() -> StageMap | None:
    """The map of the newest capture that recorded one."""
    return _newest_map


def stage_map_of(names, starts, ops: int, parts=()) -> StageMap:
    """The map of marks `names` at device operations `starts`: a mark at
    the same operation as the next one is dropped (its stage ran none).
    `parts` are kept as they are."""
    kept_names, kept_starts = [], []
    for name, start in zip(names, starts):
        if kept_starts and kept_starts[-1] == start:
            kept_names[-1] = name
        else:
            kept_names.append(name)
            kept_starts.append(start)
    return StageMap(tuple(kept_names), tuple(kept_starts), ops, tuple(parts))


def parts_of(marks, positions, ops: int) -> list[Part]:
    """The parts between part marks `marks` [(name or None, size)] at
    device operations `positions`: each named mark opens a part that the
    next mark closes (the capture's end closes the last)."""
    parts, open_ = [], None
    for (name, size), at in zip(marks, positions):
        if open_ is not None:
            parts.append(dataclasses.replace(open_, end=at))
        open_ = None if name is None else Part(name, at, ops, size)
    if open_ is not None:
        parts.append(open_)
    return parts


class StageRecorder:
    """Records the stages marked (`stage`) and their parts (`part`) while it
    is entered, inside a CUDA graph capture, and sets `map` when the block
    ends without an error, before the capture does. Marks of one name in a
    row make one stage. At each new stage and at each part mark `tail()`
    reads the capture's current node (an int, 0 before the first
    operation; None where the capture forked); at the end `positions(tails)`,
    given every node read in the order read, gives each node's count of
    nodes up to it and their total (None where the graph is not one chain).
    A capture it cannot map gets no map and a warning. Without `tail` it
    records nothing."""

    def __init__(self, tail=None, positions=None) -> None:
        self.tail, self.positions = tail, positions
        self.names: list[str] = []
        self.parts: list[tuple] = []
        #: every node read, the stages' and the parts' in the order read,
        #: and whether each was a part's
        self.tails: list[int] = []
        self.of_part: list[bool] = []
        self.failed: str | None = None
        self.map: StageMap | None = None

    def _read(self, of_part: bool) -> bool:
        node = self.tail()
        if node is None:
            self.failed = "the capture forked"
            return False
        self.tails.append(node)
        self.of_part.append(of_part)
        return True

    def mark(self, name: str) -> None:
        # a mark of the stage already open (the next of a run of internal
        # slots) continues it and reads nothing
        if self.failed is None and (not self.names or self.names[-1] != name):
            if self._read(False):
                self.names.append(name)

    def mark_part(self, name: str | None, size: tuple) -> None:
        if self.failed is None and self._read(True):
            self.parts.append((name, size))

    def __enter__(self):
        global _recorder
        if self.tail is not None:
            _recorder = self
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        global _recorder, _newest_map
        _recorder = None
        if exc_type is not None or self.tail is None:
            return False
        found = None if self.failed else self.positions(self.tails)
        if found is None:
            warnings.warn(f"no stage map recorded: {self.failed or 'the graph is not one chain'}",
                          RuntimeWarning, stacklevel=2)
            return False
        positions, ops = found
        starts = [at for at, of_part in zip(positions, self.of_part) if not of_part]
        at_parts = [at for at, of_part in zip(positions, self.of_part) if of_part]
        self.map = _newest_map = stage_map_of(self.names, starts, ops,
                                              parts_of(self.parts, at_parts, ops))
        return False


def _graph_nodes_lib() -> ctypes.CDLL:
    """csrc/graph_nodes.cu, built and loaded, its runtime started."""
    from magics_tpu_torch.kernels.build import load

    lib = load("graph_nodes")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.graph_nodes_start.argtypes = []
    lib.graph_nodes_start.restype = ctypes.c_int
    lib.graph_capture_tail.argtypes = [ptr, ctypes.POINTER(ptr)]
    lib.graph_capture_tail.restype = ctypes.c_int
    lib.graph_capture_positions.argtypes = [ptr, ctypes.POINTER(ptr), i64,
                                            ctypes.POINTER(i64)]
    lib.graph_capture_positions.restype = i64
    if lib.graph_nodes_start() != 0:
        raise RuntimeError("graph_nodes: the CUDA runtime did not start")
    return lib


def capture_recorder(device: torch.device):
    """A `StageRecorder` of the capture on `device`'s current stream, to
    enter inside the capture; made before it (the library is built and
    its runtime started here, which a capture would refuse)."""
    from magics_tpu_torch.kernels.build import current_stream

    lib = _graph_nodes_lib()
    index = device.index if device.index is not None else torch.cuda.current_device()
    out, stream = ctypes.c_void_p(), ctypes.c_void_p()
    ref, read_tail = ctypes.byref(out), lib.graph_capture_tail

    def tail():
        if not stream.value:   # the capture's stream, current from its start
            stream.value = current_stream(index)
        if read_tail(stream, ref) != 0:
            return None
        return out.value or 0

    def positions(tails):
        n = len(tails)
        found = (ctypes.c_longlong * n)()
        ops = lib.graph_capture_positions(current_stream(index),
                                          (ctypes.c_void_p * n)(*tails), n, found)
        return None if ops < 0 else (list(found), ops)

    return StageRecorder(tail, positions)


#: names of operations that a replay queues outside its graph: a registered
#: generator's seed and offset fills
OUTSIDE_GRAPH = ("FillFunctor",)

#: the slot kernels and the stage each runs in (graph/gbp.py:iterate_gbp_hot)
SLOT_STAGES = {"internal_slot_kernel": "gbp.internal", "variable_slot_kernel": "gbp.external",
               "interrobot_slot_kernel": "gbp.external", "gather_rows_kernel": "gbp.external",
               "compact_table_kernel": "gbp.external", "compact_message_kernel": "gbp.external"}


def _stage_at(stages: StageMap, position: int) -> str:
    return stages.names[bisect.bisect_right(stages.starts, position) - 1]


def slots_in_place(ops, stages: StageMap, first: int = 0) -> bool:
    """Whether every slot kernel among `ops` (in the order they ran, the
    first at the map's operation `first`) falls in its slot's stage, and
    at least one does."""
    seen = False
    for i, op in enumerate(ops):
        for kernel, want in SLOT_STAGES.items():
            if kernel in op[0]:
                if _stage_at(stages, first + i) != want:
                    return False
                seen = True
    return seen


def _placed(trace_ops, stages: StageMap):
    """(the operations of one profiled replay of the mapped graph in the
    order they ran, the map's operation the first of them is), or None
    where they do not fit the map (`stage_device_ms` says how they are
    placed)."""
    ops = sorted(trace_ops, key=lambda op: op[1])
    extra = len(ops) - stages.ops
    first = max(0, -extra)
    if extra > 0:
        if not all(any(k in op[0] for k in OUTSIDE_GRAPH) for op in ops[:extra]):
            return None
        ops = ops[extra:]
    elif first and (first >= stages.ops or not slots_in_place(ops, stages, first)):
        return None
    return ops, first


def stage_device_ms(trace_ops, stages: StageMap, ticks: int) -> dict[str, float] | None:
    """Device milliseconds a tick by stage name, from the device operations
    of one profiled replay of the mapped graph (name, start ns, end ns, ...;
    kernels, copies and fills). Operations queued before the graph's own
    (`OUTSIDE_GRAPH`) are left out first. A profiler session may miss the
    first operations a replay runs: the rest are then placed from the
    replay's end, and kept only where every slot kernel falls in its slot's
    stage (the missed ones count nothing). None where the operations do not
    fit the map."""
    placed = _placed(trace_ops, stages)
    if placed is None:
        return None
    ops, first = placed
    out: dict[str, float] = {}
    ends = stages.starts[1:] + (stages.ops,)
    for name, a, b in zip(stages.names, stages.starts, ends):
        ns = sum(op[2] - op[1] for op in ops[max(0, a - first):max(0, b - first)])
        out[name] = out.get(name, 0.0) + ns / 1e6 / ticks
    return out


def part_device_ms(trace_ops, stages: StageMap, ticks: int) -> dict[str, tuple] | None:
    """(device ms, device operations, calls) a tick by part name, from the
    operations of one profiled replay of the mapped graph, placed as
    `stage_device_ms` places them; a part that begins in the operations the
    profiler missed counts nothing. None where the operations do not fit
    the map."""
    placed = _placed(trace_ops, stages)
    if placed is None:
        return None
    ops, first = placed
    out: dict[str, list] = {}
    for p in stages.parts:
        if p.start >= first:
            ns = sum(op[2] - op[1] for op in ops[p.start - first:p.end - first])
            total = out.setdefault(p.name, [0, 0, 0])
            total[0] += ns
            total[1] += p.end - p.start
            total[2] += 1
    return {name: (ns / 1e6 / ticks, n / ticks, calls / ticks)
            for name, (ns, n, calls) in out.items()}

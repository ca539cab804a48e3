"""What the per-layer readers of the program's own records share: the
program's spans inside a traced window (magics_tpu_torch/profiling.py
`intervals`), the device-idle time that no leaf span names, and the stage
map of the newest captured chunk graph applied to a profiled replay
(`stage_device_ms`).

The program is imported inside each function, after the cell's loop returned.
A program without these records (an older checkout) gives None.
"""

from __future__ import annotations

#: spans that hold other spans of the program and name no work of their own
CONTAINERS = ("sim.advance", "sim.run", "sim.chunk")

#: the stages of graph/tick.py:step and kernels/hot.py each `stage_ms.*`
#: metric reads; `rest` is every other stage (the layout changes included)
STAGE_GROUPS = {
    "grid": ("connectivity", "collisions"),
    "internal": ("gbp.internal",),
    "external": ("gbp.external",),
}


def _profiling():
    try:
        from magics_tpu_torch import profiling
    except ImportError:
        return None
    return profiling


def window_spans(out):
    """(the traced window, the program's spans inside it, clipped to it),
    or None where the run traced no window or the program keeps no spans."""
    trace = out.traces.get("window")
    profiling = _profiling()
    if trace is None or profiling is None or not hasattr(profiling, "intervals"):
        return None
    spans = profiling.intervals(trace.start_ns, trace.end_ns)
    return (trace, spans) if spans else None


def span_ns(spans, name: str) -> int:
    return sum(e - s for n, s, e in spans if n == name)


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unnamed_share(out) -> float | None:
    """% of the traced window's device-idle time (no kernel, copy or fill
    running) in which no leaf span of the program was open: the innermost
    open span is none or a container (`CONTAINERS`)."""
    found = window_spans(out)
    if found is None:
        return None
    trace, spans = found
    gaps = [list(g) for g in trace.idle_gaps()]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    leaves = _union((s, e) for n, s, e in spans if n not in CONTAINERS)
    return 100.0 * (idle - _overlap_ns(gaps, leaves)) / idle


def stage_ms(out, group: str) -> float | None:
    """Device ms a tick of one group of stages (`STAGE_GROUPS`, or "rest")
    in the profiled replay (out.traces["replay"]), split by the stage map
    of the newest captured graph; None where the map does not fit it."""
    trace, ticks = out.traces.get("replay"), out.stats.get("replay_ticks")
    profiling = _profiling()
    if (trace is None or not ticks or profiling is None
            or not hasattr(profiling, "newest_stage_map")):
        return None
    stages = profiling.newest_stage_map()
    if stages is None:
        return None
    per_stage = profiling.stage_device_ms(trace.ops, stages, ticks)
    if per_stage is None:
        return None
    if group == "rest":
        named = {name for names in STAGE_GROUPS.values() for name in names}
        return sum(ms for name, ms in per_stage.items() if name not in named)
    return sum(per_stage.get(name, 0.0) for name in STAGE_GROUPS[group])

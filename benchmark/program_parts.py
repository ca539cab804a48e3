"""What the readers of the exchange's parts share: the parts of the newest
captured chunk graph's map (magics_tpu_torch/profiling.py `part`, below
the stages that program_spans.py reads) applied to one profiled replay of
that graph (`part_device_ms`).

A program without part maps (an older checkout), or a graph whose
exchange marks no parts (the sender exchange), gives None.
"""

from __future__ import annotations

from benchmark.program_spans import _profiling

#: the parts of one receiver-computes exchange, in the order they run
EXCHANGE = ("exchange.tables", "exchange.gather", "exchange.messages", "exchange.deliver")


def exchange_parts(out) -> dict | None:
    """{part: (device ms, device operations, calls) a tick} of the
    exchange's parts in the profiled replay (out.traces["replay"]), or
    None where a part is missing."""
    trace, ticks = out.traces.get("replay"), out.stats.get("replay_ticks")
    profiling = _profiling()
    if (trace is None or not ticks or profiling is None
            or not hasattr(profiling, "part_device_ms")):
        return None
    stages = profiling.newest_stage_map()
    if stages is None or not stages.parts:
        return None
    per_part = profiling.part_device_ms(trace.ops, stages, ticks)
    if per_part is None or not all(name in per_part for name in EXCHANGE):
        return None
    return {name: per_part[name] for name in EXCHANGE}


def exchange_size(out) -> tuple | None:
    """(robots, slots, external variables) the exchange ran at, from its
    first part in the newest map."""
    profiling = _profiling()
    stages = profiling.newest_stage_map() if hasattr(profiling, "newest_stage_map") else None
    size = next((p.size for p in getattr(stages, "parts", ()) if p.name == EXCHANGE[0]), None)
    return tuple(size) if size else None

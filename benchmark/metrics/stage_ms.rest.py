"""Device milliseconds a tick in every stage outside the connectivity,
collisions and the GBP slots: spawns, waypoints, priors, message counts,
goal areas, the log, the hand-off, the GBP layout changes and the chunk's
copy, from one profiled replay of the cell's chunk graph split by the
program's stage map of that graph (profiling.stage_device_ms)."""

from benchmark.program_spans import stage_ms


def read(out):
    return stage_ms(out, "rest")

"""Device milliseconds a tick in the connectivity and collision stages (grid or
dense) of each tick, from one profiled replay of the cell's chunk graph
split by the program's stage map of that graph (profiling.stage_device_ms)."""

from benchmark.program_spans import stage_ms


def read(out):
    return stage_ms(out, "grid")

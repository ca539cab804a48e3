"""Device milliseconds a tick in the external GBP slots (the external factor
pass with K3, the external sums, K2 and the K4 delivery), from one profiled
replay of the cell's chunk graph split by the program's stage map of that
graph (profiling.stage_device_ms)."""

from benchmark.program_spans import stage_ms


def read(out):
    return stage_ms(out, "external")

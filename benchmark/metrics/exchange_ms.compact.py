"""Device milliseconds a tick in the receiver-computes compact exchange:
its four parts (each robot's table, the gates and the peers' rows, the
messages, the delivery), from one profiled replay of the cell's chunk
graph split by the program's part map of that graph
(profiling.part_device_ms)."""

from benchmark.program_parts import exchange_parts


def read(out):
    parts = exchange_parts(out)
    return None if parts is None else sum(ms for ms, _, _ in parts.values())

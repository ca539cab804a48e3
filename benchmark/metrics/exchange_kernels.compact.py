"""Device operations (kernels, copies and fills) a tick in the
receiver-computes compact exchange's four parts, from one profiled replay
of the cell's chunk graph split by the program's part map of that graph."""

from benchmark.program_parts import exchange_parts


def read(out):
    parts = exchange_parts(out)
    return None if parts is None else sum(n for _, n, _ in parts.values())

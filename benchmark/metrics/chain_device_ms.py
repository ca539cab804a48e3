"""Device milliseconds a tick in kernels other than those that implement
the four GBP slot operations (the internal slot, the variable slot, the
sender's message table and the row gather), from one profiled replay of
the cell's chunk graph: the tick chain's plain operations, the external
sums and the grid tables."""

from benchmark.harness import kernel_time

SLOT_KERNELS = ("internal_slot_kernel", "variable_slot_kernel", "interrobot_slot_kernel",
                "gather_rows_kernel")


def read(out):
    trace = out.traces.get("replay")
    if trace is None or not trace.kernels:
        return None
    total = sum(e - s for _, s, e, _ in trace.kernels) / 1e9
    slots, _ = kernel_time(trace, SLOT_KERNELS)
    return 1e3 * (total - slots) / out.stats["replay_ticks"]

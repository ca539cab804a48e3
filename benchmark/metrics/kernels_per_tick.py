"""Device kernels in one profiled replay of the cell's chunk graph, over
its ticks."""


def read(out):
    trace = out.traces.get("replay")
    if trace is None or not trace.kernels:
        return None
    return len(trace.kernels) / out.stats["replay_ticks"]

"""Share of a traced stretch of the window (chunks with their host work)
in which no kernel ran on the device, in %: 1 less the union of the
kernels' intervals over the traced time."""

from benchmark.harness import idle_share


def read(out):
    return idle_share(out.traces.get("window"))

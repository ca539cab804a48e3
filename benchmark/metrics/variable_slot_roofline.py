"""The variable slot's (an external slot's belief update) share of its
roofline, in %: the least time the card could take for one slot at the
cell's state (benchmark/rooflines.py) over the mean device time of the
kernels that implement it in one profiled replay."""

from benchmark.harness import roofline_share

KERNELS = ("variable_slot_kernel",)


def read(out):
    return roofline_share(out, "variable_slot", KERNELS)

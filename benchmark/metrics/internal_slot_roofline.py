"""The internal GBP slot's share of its roofline, in %: the least time the
card could take for one slot at the cell's state (the larger of its bytes
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, benchmark/
rooflines.py) over the mean device time of the kernels that implement it
in one profiled replay."""

from benchmark.harness import roofline_share

KERNELS = ("internal_slot_kernel",)


def read(out):
    return roofline_share(out, "internal_slot", KERNELS)

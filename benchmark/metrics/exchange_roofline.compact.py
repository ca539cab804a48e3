"""The compact exchange's share of its roofline, in %: the least time the
card could take for one external slot's exchange at the traced state (the
larger of its bytes over 3.35 TB/s and its float32 operations over 67
TFLOP/s, benchmark/exchange_work.py) over the device time of one slot's
exchange in one profiled replay (each part's device time a call, summed).

The sizes are those the program's part marks recorded. The delivered
slots are read as the live ones (the run's message line: its mean degree
times its robots), as in this cell's traffic every robot sends and dense
connectivity, dropping no neighbour, keeps every live slot reciprocal
(benchmark/tests/test_bench_compact_exchange.py holds the two equal)."""

from benchmark import exchange_work
from benchmark.harness import card, log
from benchmark.program_parts import exchange_parts, exchange_size
from benchmark.rooflines import least_seconds


def read(out):
    parts, size, live = exchange_parts(out), exchange_size(out), exchange_work.live_slots(out)
    if parts is None or size is None or live is None:
        return None
    slot_s = sum(ms / calls for ms, _, calls in parts.values() if calls) / 1e3
    if slot_s <= 0:
        return None
    nbytes, ops = exchange_work.exchange_work(*size, live)
    least, bound = least_seconds(nbytes, ops)
    share = 100.0 * least / slot_s
    log(f"[roofline] compact exchange at {size}, {live} delivered slots: {nbytes} bytes, {ops} "
        f"operations, least {1e6 * least:.3f} us ({bound}), measured {1e6 * slot_s:.3f} us a "
        f"slot: {share:.3f}% ({card()})")
    return share

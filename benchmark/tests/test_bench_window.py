"""The window's arithmetic: a rate is every tick over the whole window, and
the tail is taken over every chunk, so a planted stall moves both."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402
from benchmark.tests.bench_cells import SMALL, small_cell  # noqa: E402

LIVE = H.driver("live")


def test_rate_counts_every_tick_over_the_whole_window():
    chunks = [0.02] * 100
    got = LIVE.window_metrics(chunks, window_s=2.5, chunk_ticks=5)
    # 500 ticks in 2.5 s: the 0.5 s outside the chunks (resets) counts
    assert abs(got["tick_ms"] - 5.0) < 1e-12
    assert abs(got["chunk_ms_p95"] - 20.0) < 1e-9


def test_a_planted_stall_moves_the_rate_and_the_tail():
    base = [0.02] * 100
    stalled = [0.02] * 90 + [0.2] * 10
    a = LIVE.window_metrics(base, sum(base), 5)
    b = LIVE.window_metrics(stalled, sum(stalled), 5)
    assert b["tick_ms"] > 1.5 * a["tick_ms"]
    assert b["chunk_ms_p95"] > 5 * a["chunk_ms_p95"]


def test_a_stall_outside_the_chunks_moves_the_rate_only():
    chunks = [0.02] * 100
    a = LIVE.window_metrics(chunks, sum(chunks), 5)
    b = LIVE.window_metrics(chunks, sum(chunks) + 1.0, 5)
    assert b["tick_ms"] > a["tick_ms"] and b["chunk_ms_p95"] == a["chunk_ms_p95"]


def test_the_live_driver_measures_a_stall_in_its_loop(monkeypatch):
    """The live driver's own window over the program on the CPU (6 robots),
    with every second chunk stalled by 3 s: the tail and the rate see it."""
    import torch

    from magics_tpu_torch.sim.simulator import Simulator

    torch.set_num_threads(2)
    cell = small_cell("circle-experiment.live", SMALL["circle-experiment.live"])
    real = Simulator.advance

    def run(stall: bool):
        calls = [0]

        def advance(self, *a, **k):
            calls[0] += 1
            if stall and calls[0] % 2 == 0:
                time.sleep(3.0)
            return real(self, *a, **k)

        monkeypatch.setattr(Simulator, "advance", advance)
        ctx = H.Context(cell, 20260417, 2.0, False, device="cpu")
        return LIVE.run(ctx).end_to_end

    plain, stalled = run(False), run(True)
    assert stalled["chunk_ms_p95"] > plain["chunk_ms_p95"] + 1500
    assert stalled["tick_ms"] > plain["tick_ms"]


def test_busy_time_is_the_union_of_intervals_in_time_order():
    """Overlapping and nested operations count once, whatever their names."""
    ops = [("z", 0, 10, "kernel"), ("a", 5, 20, "kernel"), ("m", 30, 40, "copy"),
           ("b", 32, 35, "kernel")]
    trace = H.Trace(ops=ops, window_s=1e-7, start_ns=0, end_ns=100)
    assert trace.busy_s() == 30e-9
    assert trace.busy_s(kinds=("kernel",)) == 23e-9
    assert H.idle_share(trace) == 100.0 * (1 - 23e-9 / 1e-7)
    assert trace.idle_gaps() == [(20, 30), (40, 100)]

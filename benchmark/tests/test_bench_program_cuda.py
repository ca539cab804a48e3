"""The program's own records on the card, as the per-layer readers use them
(benchmark/program_spans.py): a span around a kernel and the wait for it
brackets that kernel's device interval in the benchmark's device trace
(one clock); the stage map of a captured chunk of the swarm and of the
live view fits a profiled replay of that chunk: one device operation per
mapped node (less the first few a profiler session may miss), every slot
kernel in a stage of its slot, the stages summing to the replay's device
time; and a chunk captured with its map replays bit for bit as one
captured without.

    python -m pytest benchmark/tests/test_bench_program_cuda.py -q -m cuda
"""

import bisect
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import deploy  # noqa: E402
from benchmark import harness as H  # noqa: E402

pytestmark = pytest.mark.cuda

SEED = 2_718_281_828


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans are held to the card's trace")


def _record(record: bool, monkeypatch):
    """Captures with their stage maps, or with a recorder that records none."""
    from magics_tpu_torch import profiling

    real = profiling.capture_recorder
    monkeypatch.setattr(profiling, "capture_recorder",
                        real if record else lambda device: profiling.StageRecorder())


def _swarm(record: bool, monkeypatch):
    from magics_tpu_torch.graph.chunk import compile_ticks

    _record(record, monkeypatch)
    cell = H.cell("swarm-16384.batch")
    params, state, sdf = deploy.swarm_scenario(cell.config, SEED)
    return compile_ticks(state, sdf, params, cell.traffic["chunk_ticks"])


def _live(record: bool, monkeypatch):
    from magics_tpu_torch.sim.simulator import Simulator

    _record(record, monkeypatch)
    cell = H.cell("circle-experiment.live")
    chunk = cell.traffic["chunk_ticks"]
    sim = Simulator(deploy.circle_scenario(cell.config, SEED), seed=SEED)
    sim.advance(chunk, chunk_ticks=chunk)
    return sim.graphs[chunk]


CELLS = {"swarm": _swarm, "live": _live}


def _replay_ops(graph, want):
    """The device operations of one profiled replay, in the order they ran.
    A profiler session now and then misses the first operations of a
    replay (PERF.md §5), so up to three sessions are tried for one that
    recorded at least `want` (in some processes every session misses the
    same first two)."""
    for _ in range(3):
        traces = []
        with H.device_trace(traces):
            graph.replay()
        ops = sorted(traces[0].ops, key=lambda op: op[1])
        if len(ops) >= want:
            break
        print(f"a profiled replay recorded {len(ops)} of {want} operations; again")
    return ops


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_stage_map_fits_a_replay(card, cell, monkeypatch):
    from magics_tpu_torch import profiling

    graph = CELLS[cell](True, monkeypatch)
    stages = graph.stages
    assert stages is not None and profiling.newest_stage_map() is stages
    ops = _replay_ops(graph, stages.ops)
    # no operation outside the graph in these cells; `missed` the replay's
    # first operations that the profiler did not record
    missed = stages.ops - len(ops)
    print(f"{cell}: {stages.ops} device operations mapped in {len(stages.names)} stages; the "
          f"profiled replay recorded {len(ops)}")
    assert 0 <= missed < 10
    per_stage = profiling.stage_device_ms(ops, stages, graph.n)
    assert per_stage is not None
    for i, (name, *_rest) in enumerate(ops):
        stage = stages.names[bisect.bisect_right(stages.starts, missed + i) - 1]
        for kernel, want in profiling.SLOT_STAGES.items():
            if kernel in name:
                assert stage == want, (i, name, stage)
    launched = {k: sum(k in op[0] for op in ops) for k in profiling.SLOT_STAGES}
    assert all(launched.values()), launched
    device_ms = sum(e - s for _, s, e, _ in ops) / 1e6 / graph.n
    print(f"{cell}: {device_ms:.4f} device ms a tick; by stage "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(per_stage.items(), key=lambda x: -x[1])))
    assert sum(per_stage.values()) == pytest.approx(device_ms, rel=1e-3)


def _bits(t):
    import torch

    return t.detach().reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_mapped_capture_replays_bit_equal(card, cell, monkeypatch):
    import torch

    graphs = [CELLS[cell](record, monkeypatch) for record in (True, False)]
    assert graphs[0].stages is not None and graphs[1].stages is None
    for graph in graphs:
        for _ in range(2):
            graph.replay()
    torch.cuda.synchronize()
    mapped, plain = (g.state for g in graphs)
    assert int(mapped.tick) == int(plain.tick) > 0
    for f in dataclasses.fields(mapped):
        assert torch.equal(_bits(getattr(mapped, f.name)), _bits(getattr(plain, f.name))), f.name


def test_a_span_brackets_the_kernel_it_waits_for(card):
    import torch

    from magics_tpu_torch import profiling

    traces = []
    with H.device_trace(traces):
        # the session's first launch of the kernel pays for the profiler's
        # set-up; the one timed is the second
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with profiling.span("test.sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    trace = traces[0]
    (_, s, e), = [iv for iv in profiling.intervals(trace.start_ns, trace.end_ns)
                  if iv[0] == "test.sleep"]
    # torch.cuda._sleep's kernel is ATen's spin_kernel
    (_, ks, ke, _), = [op for op in trace.ops
                       if "spin_kernel" in op[0] and op[2] - op[1] > 1_000_000]
    print(f"span {s}-{e}, kernel {ks}-{ke}: starts {ks - s} ns apart, ends {e - ke} ns")
    assert abs(ks - s) < 100_000 and abs(e - ke) < 100_000

"""The cell circle-bench-1024.batch on the card: the unbroken run reads
`correct` and the TF32 control does not, each broken replay of
test_bench_checks.py reads `correct` false, and the program's part map of
the compact graph fits a profiled replay: every slot kernel in its slot's
stage, the exchange's four parts inside the external slots' device time,
the marks adding no device operation, a mapped capture replaying bit for
bit as one captured without its map.

    python -m pytest benchmark/tests/test_bench_compact_exchange_cuda.py -q -m cuda
"""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import deploy, messages  # noqa: E402
from benchmark import harness as H  # noqa: E402
from benchmark.tests.test_bench_checks import FAULTS, graph_fault  # noqa: E402,F401

pytestmark = pytest.mark.cuda

CELL = "circle-bench-1024.batch"
SEED = 2_718_281_828_459


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batch driver replays CUDA graphs")


def _run(control=False, seconds=2.0):
    ctx = H.Context(H.cell(CELL), SEED, seconds, False, control=control)
    return H.driver(ctx.cell.traffic["driver"]).run(ctx)


def test_unbroken_run_is_correct_and_the_control_is_not(card):
    out = _run(control=True)
    H.log(f"{CELL}: " + ", ".join(f"{c.name} {c.value!r}" for c in out.checks)
          + " | control: " + ", ".join(f"{c.name} {c.value!r}" for c in out.control))
    assert out.failed == 0 and H.correct(out.checks), out.checks
    assert out.control and not H.correct(out.control), out.control


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_replay_is_not_correct(card, graph_fault, fault):  # noqa: F811
    graph_fault(fault)
    out = _run()
    assert [c for c in out.checks if not c.ok], out.checks


def _graph(record: bool, monkeypatch):
    import torch

    from magics_tpu_torch import profiling
    from magics_tpu_torch.graph.chunk import compile_ticks

    if not record:
        monkeypatch.setattr(profiling, "capture_recorder",
                            lambda device: profiling.StageRecorder())
    cell = H.cell(CELL)
    params, state, sdf = deploy.swarm_scenario(cell.config, SEED)
    graph = compile_ticks(state, sdf, params, cell.traffic["chunk_ticks"])
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return params, graph


def _replay(graph, want):
    """One profiled replay that recorded at least `want` operations (a
    session now and then misses a replay's first few), of three tried."""
    for _ in range(3):
        traces = []
        with H.device_trace(traces):
            graph.replay()
        if len(traces[0].ops) >= want:
            break
    return traces[0]


def test_the_parts_fit_a_replay_inside_the_external_stage(card, monkeypatch):
    from magics_tpu_torch import profiling

    params, graph = _graph(True, monkeypatch)
    stages = graph.stages
    assert stages is not None and profiling.newest_stage_map() is stages
    n_ext = sum(1 for _, e in params.schedule if e) * graph.n
    assert [p.name for p in stages.parts] == [
        "exchange.tables", "exchange.gather", "exchange.messages", "exchange.deliver"] * n_ext
    trace = _replay(graph, stages.ops - 5)
    ops = sorted(trace.ops, key=lambda op: op[1])
    missed = stages.ops - len(ops)
    assert 0 <= missed < 10
    assert profiling.slots_in_place(ops, stages, missed)
    out = H.Outcome(attempted=1, failed=0, traces={"replay": trace},
                    stats={"replay_ticks": graph.n},
                    notes=[messages.line(params, graph.state, 10.0)])
    read = {m: H.reader(m).read(out) for m in (
        "stage_ms.external", "stage_ms.internal", "exchange_ms.compact",
        "exchange_kernels.compact", "exchange_roofline.compact", "kernels_per_tick")}
    H.log(f"{CELL}: {read} ({H.card()})")
    assert all(v is not None for v in read.values()), read
    assert 0 < read["exchange_ms.compact"] <= read["stage_ms.external"]
    assert 0 < read["exchange_kernels.compact"] < read["kernels_per_tick"]
    assert 0 < read["exchange_roofline.compact"] < 100


def _bits(t):
    import torch

    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def test_the_marks_add_no_operation_and_change_no_bit(card, monkeypatch):
    import torch

    (_, mapped), (_, plain) = (_graph(record, monkeypatch) for record in (True, False))
    assert mapped.stages is not None and plain.stages is None
    assert mapped.launches == plain.launches
    traces = []
    for graph in (mapped, plain):
        with H.device_trace(traces):
            graph.replay()
    names = [[op[0] for op in sorted(t.ops, key=lambda op: op[1])] for t in traces]
    # the same operations, but the first few a profiler session may miss
    n = min(map(len, names))
    assert mapped.stages.ops - 10 < n and max(map(len, names)) <= mapped.stages.ops
    assert names[0][-n:] == names[1][-n:]
    for f in dataclasses.fields(mapped.state):
        a, b = getattr(mapped.state, f.name), getattr(plain.state, f.name)
        assert torch.equal(_bits(a), _bits(b)), f.name

"""The readers of the program's own records (benchmark/program_spans.py and
the metrics that use it) on synthetic outcomes: the program's spans and
stage map stand in for a traced run's, the device trace is made up. Each
reader returns None where the outcome or the program has nothing to read."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402
from benchmark import program_spans as S  # noqa: E402

MS = 1_000_000
NEW = ("warmup_share.sweep", "idle_unnamed.sweep", "run_host_ms.live", "idle_unnamed.tick",
       "stage_ms.grid", "stage_ms.internal", "stage_ms.external", "stage_ms.rest")


@pytest.fixture
def program(monkeypatch):
    """The program's profiling module with its records set by the test."""
    from magics_tpu_torch import profiling

    monkeypatch.setattr(profiling, "_intervals", [])
    monkeypatch.setattr(profiling, "_newest_map", None)
    return profiling


def _window(busy, start=0, end=100 * MS):
    """A traced window whose device runs the kernels `busy` [(start, end)]."""
    ops = [("kernel", s, e, "kernel") for s, e in busy]
    return H.Trace(ops=ops, window_s=(end - start) / 1e9, start_ns=start, end_ns=end)


def _outcome(**traces):
    return H.Outcome(attempted=1, failed=0, traces=traces, stats={"replay_ticks": 2})


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_returns_none_with_nothing_to_read(metric, program):
    reader = H.reader(metric)
    assert reader.read(H.Outcome(attempted=0, failed=0)) is None
    # a traced run in which the program kept no span and mapped no graph
    window = _window([(0, 10 * MS)])
    assert reader.read(_outcome(window=window, replay=window)) is None


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_returns_none_for_a_program_without_records(metric, monkeypatch):
    """A checkout whose profiling module predates spans and stage maps."""
    monkeypatch.setattr(S, "_profiling", lambda: object())
    window = _window([(0, 10 * MS)])
    assert H.reader(metric).read(_outcome(window=window, replay=window)) is None


def test_warmup_share_reads_the_warmup_spans_inside_the_window(program):
    program._intervals[:] = [
        ("graph.warmup", -20 * MS, 10 * MS), ("graph.capture", 10 * MS, 50 * MS),
        ("graph.warmup", 60 * MS, 75 * MS), ("graph.warmup", 200 * MS, 300 * MS)]
    out = _outcome(window=_window([(0, 5 * MS)]))
    assert H.reader("warmup_share.sweep").read(out) == pytest.approx(25.0)


def test_idle_unnamed_counts_idle_time_under_containers_or_no_span(program):
    # idle: 10-40 and 60-100 ms (70 ms); leaves cover 10-30 and 70-90 ms
    # (40 ms of it); a container alone covers 30-40, nothing 60-70 and 90-100
    program._intervals[:] = [
        ("sim.sample", 10 * MS, 20 * MS), ("sim.own", 20 * MS, 30 * MS),
        ("sim.chunk", 0, 45 * MS), ("sim.export", 70 * MS, 90 * MS),
        ("sim.run", 0, 50 * MS), ("sim.advance", 0, 100 * MS)]
    out = _outcome(window=_window([(0, 10 * MS), (40 * MS, 60 * MS)]))
    for metric in ("idle_unnamed.sweep", "idle_unnamed.tick"):
        assert H.reader(metric).read(out) == pytest.approx(100.0 * 30 / 70)


def test_run_host_ms_is_advance_less_its_wait_a_chunk(program):
    program._intervals[:] = [
        ("sim.wait", 2 * MS, 8 * MS), ("sim.run", 1 * MS, 12 * MS), ("sim.advance", 0, 13 * MS),
        ("sim.wait", 22 * MS, 30 * MS), ("sim.advance", 20 * MS, 35 * MS)]
    out = _outcome(window=_window([(0, 5 * MS)]))
    assert H.reader("run_host_ms.live").read(out) == pytest.approx(((13 - 6) + (15 - 8)) / 2)


def test_stage_ms_groups_the_stages_of_a_replay(program):
    names = ("spawns", "connectivity", "gbp.layout", "gbp.internal", "gbp.layout",
             "gbp.external", "gbp.internal", "collisions", "handoff", "chunk.copy")
    program._newest_map = program.StageMap(names, tuple(range(10)), 10)
    fills = [("void at::native::FillFunctor<long>", -5 * MS, -4 * MS, "kernel")] * 2
    ops = [(f"k{i}", 10 * MS * i, 10 * MS * i + (i + 1) * MS, "kernel") for i in range(10)]
    replay = H.Trace(ops=fills + ops, window_s=0.1, start_ns=-10 * MS, end_ns=100 * MS)
    out = _outcome(replay=replay)
    got = {g: H.reader(f"stage_ms.{g}").read(out) for g in ("grid", "internal", "external", "rest")}
    assert got == pytest.approx({"grid": (2 + 8) / 2, "internal": (4 + 7) / 2, "external": 6 / 2,
                                 "rest": (1 + 3 + 5 + 9 + 10) / 2})
    assert sum(got.values()) == pytest.approx(sum(range(1, 11)) / 2)
    # a map of another graph (another count of operations) fits nothing
    for ops in (9, 13):
        program._newest_map = program.StageMap(names, tuple(range(9)) + (ops - 1,), ops)
        assert H.reader("stage_ms.grid").read(out) is None

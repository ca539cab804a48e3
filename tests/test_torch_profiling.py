"""The port's own records (magics_tpu_torch/profiling.py) as far as the CPU
can hold them: span totals and nesting, intervals kept only while a
torch.profiler session runs, profiler ranges only under `annotate()`, the
stage marks of a tick in the order the chain runs them, the stage map's
arithmetic, the parts the receiver exchanges mark below their stage, and
the Simulator's spans. The stage map of a real capture, and the spans
against the card's clock, are held on the card
(benchmark/tests/test_bench_program_cuda.py,
benchmark/tests/test_bench_compact_exchange_cuda.py)."""

from __future__ import annotations

import itertools
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from magics_tpu_torch import profiling as P
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.sim import builder as TB


@pytest.fixture(autouse=True)
def fresh_spans():
    P.reset_spans()
    yield
    P.reset_spans()


def test_span_totals_and_nesting():
    with P.span("outer"):
        with P.span("inner"):
            time.sleep(0.01)
        with P.span("inner"):
            pass
    assert P.span_totals["inner"][0] == 2 and P.span_totals["outer"][0] == 1
    assert 10_000_000 <= P.span_totals["inner"][1] <= P.span_totals["outer"][1]


def test_span_as_a_decorator_counts_each_call_and_nests():
    @P.span("fact")
    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    assert fact(5) == 120
    assert P.span_totals["fact"][0] == 5


def test_intervals_only_while_a_profiler_runs():
    with P.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with P.span("outer"):
            with P.span("inner"):
                pass
        t1 = time.time_ns()
    with P.span("after"):
        pass
    got = P.intervals(0, 2**63)
    assert [name for name, _, _ in got] == ["inner", "outer"]
    (_, si, ei), (_, so, eo) = got
    assert t0 <= so <= si <= ei <= eo <= t1
    assert set(P.span_totals) == {"before", "outer", "inner", "after"}
    P.reset_spans()
    assert P.intervals(0, 2**63) == [] and not P.span_totals


def test_intervals_are_clipped_to_the_window(monkeypatch):
    monkeypatch.setattr(P, "_intervals", [("early", 0, 10), ("across", 5, 25), ("inside", 12, 18),
                                          ("late", 30, 40)])
    assert P.intervals(10, 20) == [("across", 10, 20), ("inside", 12, 18)]


def _span_events(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_no_profiler_range_unless_annotated():
    with profile(activities=[ProfilerActivity.CPU]) as plain:
        with P.span("spans.plain"):
            torch.ones(4).sum()
    assert not _span_events(plain, "spans.plain")
    with profile(activities=[ProfilerActivity.CPU]) as annotated, P.annotate():
        with P.span("spans.annotated"):
            torch.ones(4).sum()
    assert len(_span_events(annotated, "spans.annotated")) == 1
    assert not P._annotating


def test_stage_map_drops_marks_that_ran_nothing():
    stages = P.stage_map_of(["a", "b", "c", "d", "c"], [0, 0, 3, 3, 5], 9)
    assert stages == P.StageMap(("b", "d", "c"), (0, 3, 5), 9)


class _Counter:
    """A stand-in for the capture: every mark reads a node of its own."""

    def __init__(self):
        self.n = 0

    def tail(self):
        self.n += 1
        return self.n

    def positions(self, tails):
        return [10 * t for t in tails], 10 * self.n + 3


def test_recorder_records_marks_only_while_entered():
    counter = _Counter()
    P.stage("outside")
    with P.StageRecorder(counter.tail, counter.positions) as rec:
        P.stage("one")
        P.stage("two")
    P.stage("outside")
    assert rec.map == P.StageMap(("one", "two"), (10, 20), 23)
    assert P.newest_stage_map() is rec.map
    with P.StageRecorder() as off:
        P.stage("unrecorded")
    assert off.map is None and P.newest_stage_map() is rec.map


def test_recorder_warns_and_keeps_no_map_where_the_capture_forks(monkeypatch):
    monkeypatch.setattr(P, "_newest_map", None)
    with pytest.warns(RuntimeWarning, match="forked"):
        with P.StageRecorder(lambda: None, lambda tails: ([], 0)) as rec:
            P.stage("one")
    assert rec.map is None and P.newest_stage_map() is None
    with pytest.warns(RuntimeWarning, match="not one chain"):
        with P.StageRecorder(lambda: 1, lambda tails: None) as rec:
            P.stage("one")
    assert rec.map is None
    with pytest.raises(ValueError):
        with P.StageRecorder(lambda: 1, lambda tails: ([0], 1)) as rec:
            raise ValueError
    assert rec.map is None and P._recorder is None


def _scenario(**extra):
    specs = TB.circle_formation(6, circle_radius=18.0, target_speed=8.0)
    return TB.build_scenario(
        specs, target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=22.0,
        n_slots=5, dtype=torch.float32, device="cpu", **extra,
    )


CHAIN = ["spawns", "waypoints", "connectivity", "failed_comms", "prior_horizon",
         "prior_current"]
AFTER = ["message_counts", "collisions", "goal_areas", "log", "handoff"]


@pytest.mark.parametrize("hot", [False, True], ids=["plain", "hot"])
def test_a_tick_marks_every_stage_in_order(monkeypatch, hot):
    """Each mark at an operation of its own, so none is dropped: the step's
    systems in chain order and, inside the GBP schedule (5 internal, 2
    external slots, interleaved evenly), the hot layout's changes around
    each external slot; a run of internal slots is one stage."""
    params, state, sdf = _scenario(use_pallas=hot, internal=5, external=2)
    monkeypatch.setattr(P, "_newest_map", None)
    counter = _Counter()
    with P.StageRecorder(counter.tail, counter.positions) as rec:
        TT.step(state, sdf, params)
    slots = []
    for internal, external in params.schedule:
        if internal:
            slots.append("gbp.internal")
        if external:
            slots += ["gbp.layout", "gbp.external"] if hot else ["gbp.external"]
    assert slots.count("gbp.internal") == 5 and slots.count("gbp.external") == 2
    runs = [name for name, _ in itertools.groupby(slots)]
    assert len(runs) < len(slots)
    gbp = ["gbp.layout", *runs, "gbp.layout"] if hot else runs
    assert list(rec.map.names) == CHAIN + gbp + AFTER
    assert counter.n == len(rec.map.names)


def _ops(durations, first=0):
    """Device operations of a replay, (name, start ns, end ns, kind), back
    to back, starting at `first`."""
    out, t = [], first
    for name, d in durations:
        out.append((name, t, t + d, "kernel"))
        t += d + 1
    return out


def test_stage_device_ms_splits_a_replay_by_the_map():
    stages = P.StageMap(("a", "b", "a"), (0, 2, 3), 5)
    ops = _ops([("k1", 1_000_000), ("k2", 2_000_000), ("k3", 4_000_000),
                ("k4", 8_000_000), ("k5", 16_000_000)])
    assert P.stage_device_ms(list(reversed(ops)), stages, 2) == {"a": 13.5, "b": 2.0}
    fills = _ops([("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor"
                   "<long>, std::array<char*, 1ul> >", 500)] * 2, first=-10_000)
    assert P.stage_device_ms(fills + ops, stages, 2) == {"a": 13.5, "b": 2.0}
    assert P.stage_device_ms(_ops([("other", 500)], first=-10_000) + ops, stages, 2) is None
    # a map of more operations than the replay ran, and no slot kernel to
    # place the rest by
    assert P.stage_device_ms(ops[1:], stages, 2) is None
    assert P.stage_device_ms(ops, P.StageMap(("a",), (0,), 6), 2) is None


def test_a_replay_that_lost_its_first_operations_is_placed_from_its_end():
    """A profiler session may miss a replay's first operations: the rest
    are placed from the end where every slot kernel then falls in its
    slot's stage."""
    stages = P.StageMap(("spawns", "gbp.internal", "gbp.external", "log"), (0, 2, 4, 6), 8)
    names = ["k0", "k1", "internal_slot_kernel<8>", "k3", "variable_slot_kernel<8>",
             "gather_rows_kernel", "k6", "k7"]
    ops = _ops([(n, 1_000_000 * (i + 1)) for i, n in enumerate(names)])
    whole = P.stage_device_ms(ops, stages, 1)
    assert whole == {"spawns": 3.0, "gbp.internal": 7.0, "gbp.external": 11.0, "log": 15.0}
    assert P.slots_in_place(ops, stages)
    assert P.stage_device_ms(ops[2:], stages, 1) == {**whole, "spawns": 0.0}
    assert P.stage_device_ms(ops[1:], stages, 1) == {**whole, "spawns": 2.0}
    # lost at the end instead: the slot kernels land a stage early
    assert not P.slots_in_place(ops[:-2], stages, 2)
    assert P.stage_device_ms(ops[:-2], stages, 1) is None


# ---------------------------------------------------------------- parts

EXCHANGE = ["exchange.tables", "exchange.gather", "exchange.messages", "exchange.deliver"]


def test_parts_run_from_mark_to_mark():
    marks = [("a", (1, 2)), ("b", ()), (None, ()), ("c", (3,))]
    assert P.parts_of(marks, [2, 5, 7, 9], 12) == [
        P.Part("a", 2, 5, (1, 2)), P.Part("b", 5, 7), P.Part("c", 9, 12, (3,))]
    assert P.parts_of([], [], 4) == []


def test_recorder_keeps_parts_apart_from_the_stages(monkeypatch):
    monkeypatch.setattr(P, "_newest_map", None)
    counter = _Counter()
    P.part("outside")
    with P.StageRecorder(counter.tail, counter.positions) as rec:
        P.stage("one")
        P.part("p", 4, 5)
        P.part("q")
        P.stage("two")
        P.part(None)
        P.stage("two")
    assert rec.map == P.StageMap(("one", "two"), (10, 40), 53,
                                 (P.Part("p", 20, 30, (4, 5)), P.Part("q", 30, 50)))
    assert counter.n == 5
    with P.StageRecorder() as off:
        P.part("unrecorded")
    assert off.map is None and P.newest_stage_map() is rec.map


def test_a_part_mark_where_the_capture_forks_keeps_no_map(monkeypatch):
    monkeypatch.setattr(P, "_newest_map", None)
    with pytest.warns(RuntimeWarning, match="forked"):
        with P.StageRecorder(lambda: None, lambda tails: ([], 0)) as rec:
            P.part("p")
    assert rec.map is None and P._recorder is None


def _tick_map(exchange, hot, monkeypatch):
    params, state, sdf = _scenario(use_pallas=hot, internal=5, external=2, ext_exchange=exchange)
    monkeypatch.setattr(P, "_newest_map", None)
    counter = _Counter()
    with P.StageRecorder(counter.tail, counter.positions) as rec:
        TT.step(state, sdf, params)
    return rec.map, state


@pytest.mark.parametrize("hot", [False, True], ids=["plain", "hot"])
@pytest.mark.parametrize("exchange", ["receiver_compact", "receiver"])
def test_the_receiver_exchange_marks_its_parts_inside_each_external_slot(
        monkeypatch, exchange, hot):
    stages, state = _tick_map(exchange, hot, monkeypatch)
    sender, _ = _tick_map("sender", hot, monkeypatch)
    # the same stages as the sender's tick, the parts a map of their own
    assert stages.names == sender.names and sender.parts == ()
    assert [p.name for p in stages.parts] == EXCHANGE * 2
    R, K = state.nbr_idx.shape
    V1 = state.prior_mean.shape[1] - 1
    ends = stages.starts[1:] + (stages.ops,)
    external = [(a, b) for name, a, b in zip(stages.names, stages.starts, ends)
                if name == "gbp.external"]
    assert len(external) == 2
    for i, (a, b) in enumerate(external):
        slot = stages.parts[4 * i:4 * i + 4]
        assert a <= slot[0].start and slot[-1].end <= b
        assert all(p.end == q.start for p, q in zip(slot, slot[1:]))
        assert all(p.size == (R, K, V1) and p.start < p.end for p in slot)


def test_part_device_ms_splits_a_replay_by_part():
    parts = (P.Part("x", 1, 3), P.Part("y", 3, 4), P.Part("x", 5, 7))
    stages = P.StageMap(("a", "gbp.external"), (0, 1), 8, parts)
    ops = _ops([(f"k{i}", 1_000_000 * (i + 1)) for i in range(8)])
    assert P.part_device_ms(ops, stages, 2) == {"x": ((2 + 3 + 6 + 7) / 2, 2.0, 1.0),
                                                "y": (4 / 2, 0.5, 0.5)}
    # the split by stage reads no part
    assert P.stage_device_ms(ops, stages, 2) == P.stage_device_ms(
        ops, P.StageMap(stages.names, stages.starts, 8), 2)
    # a replay of another graph fits no map
    assert P.part_device_ms(ops[:3] + _ops([("other", 5)]), stages, 2) is None


def test_a_part_the_profiler_missed_counts_nothing():
    parts = (P.Part("x", 1, 3), P.Part("x", 5, 7))
    stages = P.StageMap(("a", "gbp.internal", "gbp.external"), (0, 1, 4), 8, parts)
    names = ["k0", "k1", "k2", "k3", "variable_slot_kernel<8>", "k5", "k6", "k7"]
    ops = _ops([(n, 1_000_000) for n in names])
    assert P.part_device_ms(ops, stages, 1) == {"x": (4.0, 4.0, 2.0)}
    assert P.part_device_ms(ops[2:], stages, 1) == {"x": (2.0, 2.0, 1.0)}


def _small_circle():
    from magics_tpu_torch.config.formation import Formation, FormationGroup
    from magics_tpu_torch.config.loader import Scenario
    from magics_tpu_torch.config.schema import Config
    from magics_tpu_torch.env import builtin

    circle = {"circle": {"radius": 15.0, "center": {"x": 0.5, "y": 0.5}}}
    toml = ("[simulation]\nhz = 10.0\nprng-seed = 3\nmax-time = 2.0\n"
            "[gbp.iteration-schedule]\ninternal = 2\nexternal = 1\n"
            "[robot]\ntarget-speed = 10.0\nplanning-horizon = 1.0\n")
    formation = Formation.parse({
        "robots": 3,
        "initial-position": {"shape": circle, "placement-strategy": "equal"},
        "waypoints": [{"shape": circle, "projection-strategy": "cross"}],
    })
    return Scenario(name="small circle", config=Config.from_toml(toml),
                    environment=builtin.circle(), formations=FormationGroup([formation]))


def test_simulator_spans_nest_in_a_chunk(tmp_path):
    """A live view's step on the CPU: `advance` holds `run`, which holds the
    tick fetch, the graph upkeep, the chunk (eager here), the diagnostics
    and the hook, the clone it hands back and its summary; no wait for a
    card. Build, reset and export have spans of their own."""
    from magics_tpu_torch.sim.simulator import Simulator

    sim = Simulator(_small_circle(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        sim.advance(2, chunk_ticks=2, on_chunk=lambda state, tick: None)
    spans = P.intervals(0, 2**63)
    names = [n for n, _, _ in spans]
    assert names.count("sim.advance") == 1 and names.count("sim.run") == 1
    assert {"sim.tick", "sim.keep", "sim.chunk", "sim.eager", "sim.sample", "sim.on_chunk",
            "sim.own", "sim.summary"} <= set(names)
    assert "sim.wait" not in names and "sim.replay" not in names

    def inside(inner, outer):
        (_, a, b), = [iv for iv in spans if iv[0] == outer]
        return all(a <= s and e <= b for n, s, e in spans if n == inner)

    assert inside("sim.run", "sim.advance") and inside("sim.chunk", "sim.run")
    assert inside("sim.eager", "sim.chunk") and inside("sim.summary", "sim.run")
    sim.reset(4)
    sim.export(tmp_path / "export.json")
    for name in ("sim.build", "sim.reset", "sim.export"):
        assert P.span_totals[name][0] == 1, name

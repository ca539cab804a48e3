"""The comparison that decides `correct` fails where it should: each
driver run through the rest of a run with the program's timed path broken
underneath (a step that leaves the state unchanged, half of the robots
left out, an answer altered where it is produced) reads `correct` false,
the unbroken run true; and the lower-precision control (the reference
with TF32 products in the program's place), judged under the cell's limits,
reads `correct` false.

The Circle cells run on the CPU (3 robots on a 15 m circle), where the
Simulator steps the program's plain passes eagerly. On the card the swarm's
cases (2,048 robots) and the Circle cells' at their own size (50 robots, a
sweep of 50-robot rows) break the CUDA graph's replay, the timed path
there."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402
from benchmark.tests.bench_cells import SMALL, small_cell  # noqa: E402

CPU_RUNS = sorted(SMALL)


def _robot_axis(name: str) -> int:
    return 1 if name in ("pos_log", "vel_log", "viz_mean", "viz_cov", "viz_trk") else 0


def unchanged(before, after):
    return before


def half_left_out(before, after):
    """Only the first half of the robots advance."""
    import torch

    R = before.pos.shape[0]
    keep = {}
    for f in dataclasses.fields(before):
        a, b = getattr(after, f.name), getattr(before, f.name)
        axis = _robot_axis(f.name)
        if a.ndim > axis and a.shape[axis] == R:
            idx = torch.arange(R, device=a.device) < R // 2
            shape = [1] * a.ndim
            shape[axis] = R
            keep[f.name] = torch.where(idx.view(shape), a, b)
    return dataclasses.replace(after, **keep)


def altered(before, after):
    """Robot 0's position, and its logged positions, 10 m off."""
    pos = after.pos.clone()
    pos[0, 0] += 10.0
    log = after.pos_log.clone()
    log[:, 0, 0] += 10.0
    return dataclasses.replace(after, pos=pos, pos_log=log)


FAULTS = [unchanged, half_left_out, altered]


def _run(name, device, sizes=None, control=False, seconds=0.5):
    ctx = H.Context(small_cell(name, sizes), 31415926535, seconds, False, device=device,
                    control=control)
    return H.driver(ctx.cell.traffic["driver"]).run(ctx)


@pytest.fixture
def cpu_eager(monkeypatch):
    """The program's eager chunk (the CPU's path) with a fault planted."""
    import torch

    from magics_tpu_torch.graph import tick as T

    torch.set_num_threads(2)
    real = T.run_ticks

    def plant(fault):
        def run_ticks(state, *args, **kwargs):
            return fault(state, real(state, *args, **kwargs))

        monkeypatch.setattr(T, "run_ticks", run_ticks)

    return plant


@pytest.mark.parametrize("name", CPU_RUNS)
def test_unbroken_cpu_run_is_correct(name, cpu_eager):
    out = _run(name, "cpu", SMALL[name])
    assert out.checks and all(c.ok for c in out.checks), out.checks


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CPU_RUNS)
def test_broken_cpu_run_is_not_correct(name, fault, cpu_eager):
    cpu_eager(fault)
    out = _run(name, "cpu", SMALL[name])
    bad = [c for c in out.checks if not c.ok]
    assert bad, out.checks


@pytest.mark.parametrize("name", CPU_RUNS)
def test_tf32_control_fails_the_limit(name, cpu_eager):
    out = _run(name, "cpu", SMALL[name], control=True)
    assert H.correct(out.checks), out.checks
    assert out.control and not H.correct(out.control), out.control


# ---------------------------------------------------------------- the card

SWARM = {"config": {"robots": 2048}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batch driver replays CUDA graphs")


@pytest.fixture
def graph_fault(monkeypatch):
    """The program's graph replay with a fault planted."""
    from magics_tpu_torch.graph.chunk import TickGraph, clone_state, copy_state_

    real = TickGraph.replay

    def plant(fault):
        def replay(self):
            before = clone_state(self.state)
            real(self)
            copy_state_(self.state, fault(before, clone_state(self.state)))
            return self.state

        monkeypatch.setattr(TickGraph, "replay", replay)

    return plant


@pytest.mark.cuda
def test_swarm_unbroken_and_control(card):
    out = _run("swarm-16384.batch", "cuda", SWARM, control=True, seconds=2.0)
    assert H.correct(out.checks), out.checks
    assert out.control and not H.correct(out.control), out.control


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_swarm_broken_replay_is_not_correct(card, graph_fault, fault):
    graph_fault(fault)
    out = _run("swarm-16384.batch", "cuda", SWARM, seconds=2.0)
    assert [c for c in out.checks if not c.ok], out.checks


# the Circle cells at their own size on the card: 50 robots; the sweep's
# rows all of 50 robots, with no warm row
CIRCLE_AT_SIZE = {
    "circle-experiment.live": {},
    "circle-experiment.sweep": {"traffic": {"rows": [50], "warm_rows": []}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", sorted(CIRCLE_AT_SIZE))
def test_circle_broken_replay_at_size_is_not_correct(card, graph_fault, name, fault):
    graph_fault(fault)
    out = _run(name, "cuda", CIRCLE_AT_SIZE[name])
    bad = [c for c in out.checks if not c.ok]
    H.log(f"{name} {fault.__name__}: " + ", ".join(f"{c.name} {c.value!r} (limit {c.limit!r})"
                                                for c in out.checks))
    assert bad, out.checks

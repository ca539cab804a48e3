"""The deployment circle-bench-1024 and its exchange on the CPU: the port's
plain ticks under the receiver-computes compact exchange equal the plain
reference's bit for bit, at the configuration cut to 48 robots and K=8; the
exchange alone equals the reference's on a random state; the exchange's
least work (benchmark/exchange_work.py) equals a count by hand; and the
exchange's readers read the program's part map of a replay, and None
where there is none.

The reference (benchmark/reference/) is a frozen copy of the port's plain
tick, so the two are compared bit for bit: positions, the inbox, the
beliefs."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import deploy, exchange_work, program_parts  # noqa: E402
from benchmark import harness as H  # noqa: E402

CELL = "circle-bench-1024.batch"
SEED = 3_141_592_653_589
METRICS = ("exchange_ms.compact", "exchange_kernels.compact", "exchange_roofline.compact")
FIELDS = ("pos", "ext_inbox", "belief_mean", "belief_eta", "belief_lam",
          "ir_v2f_ext_pos", "nbr_idx")


def small_config(**cut):
    """The configuration at 48 robots and K=8; the circle cut to 100 m so
    that each robot has ~6 neighbours in comms range."""
    return {**H.cell(CELL).config, "robots": 48, "n_slots": 8, "min_circle_radius": 100.0,
            **cut}


def _bits(t):
    import torch

    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def test_the_deployment_is_the_headline_workload():
    cfg = H.cell(CELL).config
    params, state, _ = deploy.swarm_scenario(cfg, SEED, device="cpu")
    R, K = state.nbr_idx.shape
    radius = float(state.pos.norm(dim=-1).mean())
    assert (R, K, params.n_vars) == (1024, 32, 21)
    assert radius == pytest.approx(800.0, rel=1e-6)
    assert (params.world_width, params.world_height) == (2000.0, 2000.0)
    assert params.ext_exchange == "receiver_compact" and not params.use_grid
    assert not params.tracking_enabled and not params.despawn_on_final_waypoint
    assert sum(1 for i, _ in params.schedule if i) == 50
    assert sum(1 for _, e in params.schedule if e) == 10


def test_plain_ticks_equal_the_reference():
    import torch

    from benchmark.reference import compare, scenarios
    from magics_tpu_torch.graph import tick as T

    torch.set_num_threads(2)
    cfg = small_config()
    params, state, sdf = deploy.swarm_scenario(cfg, SEED, device="cpu")
    assert not params.uses_kernels(state.device)
    ref_params, ref_state, ref_sdf = scenarios.swarm(cfg, SEED, dtype=torch.float32,
                                                     device="cpu")
    assert compare.start_gap(state, ref_state) == 0.0
    got = T.run_ticks(state, sdf, params, 5)
    want = compare.follow(ref_params, ref_state, ref_sdf, None, 5)
    assert int(got.tick) == 5 and int(got.nbr_overflow) == 0
    assert int(got.nbr_mask.sum()) > 4 * 48 and bool((got.ext_inbox != 0).any())
    for name in FIELDS:
        assert torch.equal(_bits(getattr(got, name)), _bits(getattr(want, name))), name


def _random_state(state, gen):
    """`state` with its exchange's inputs drawn at random: snapshots (each
    precision symmetric positive definite), mirrors, gates and live slots."""
    import torch

    def draw(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32)

    def coin(*shape, p=0.8):
        return torch.rand(*shape, generator=gen) < p

    R, K = state.nbr_idx.shape
    V = state.prior_mean.shape[1]
    a = draw(R, V, 4, 4)
    lam = a @ a.transpose(-1, -2) + 0.1 * torch.eye(4)
    return dataclasses.replace(
        state,
        snap_mu=state.snap_mu + draw(R, V, 4), snap_eta=draw(R, V, 4), snap_lam=lam,
        ir_v2f_ext_pos=state.ir_v2f_ext_pos + 3.0 * draw(*state.ir_v2f_ext_pos.shape),
        ir_int_seeded=coin(*state.ir_int_seeded.shape),
        ext_inbox=draw(*state.ext_inbox.shape),
        nbr_mask=state.nbr_mask & coin(R, K), nbr_has_back=state.nbr_has_back & coin(R, K),
        active=coin(R, p=0.9), antenna=coin(R, p=0.9),
    )


@pytest.mark.parametrize("exchange", ["receiver_compact", "receiver"])
def test_the_exchange_alone_equals_the_references(exchange):
    import torch

    from benchmark.reference import compare
    from benchmark.reference import tick as RT
    from magics_tpu_torch.graph import tick as T

    torch.set_num_threads(2)
    params, state, sdf = deploy.swarm_scenario(small_config(ext_exchange=exchange), SEED,
                                               device="cpu")
    state = T.run_ticks(state, sdf, params, 1)
    state = _random_state(state, torch.Generator().manual_seed(SEED % 2**31))
    got = T._external_factor_pass_receiver(state, params)
    want = RT._external_factor_pass_receiver(compare.as_reference(state), params)
    assert bool((got.ext_inbox != state.ext_inbox).any())
    for name in ("ext_inbox", "iter_count_factor"):
        assert torch.equal(_bits(getattr(got, name)), _bits(getattr(want, name))), name


def test_exchange_work_by_hand():
    # 2 robots, 3 slots, 2 external variables, 4 delivered slots
    gates = 2 * (4 * 1 + 4 + 4 + 4)           # 4 bools, radius, counter read and written
    snapshot = 2 * 2 * (4 + 4 + 16) * 4        # snap_mu, snap_eta, snap_lam, vars 1..2
    tables = 2 * 2 * 8 * 4
    neighbours = 2 * 3 * (4 + 4 + 1 + 1)       # nbr_idx, nbr_back, nbr_mask, nbr_has_back
    delivered = 4 * 2 * (1 + 2 * 4 + 4 * 4)    # seeded, ext position, inbox row
    ops = 2 * 2 * 243 + 4 * 2 * 71
    assert exchange_work.exchange_work(2, 3, 2, 4) == (
        gates + snapshot + tables + neighbours + delivered, ops)


def test_the_delivered_slots_are_the_live_ones():
    import torch

    from magics_tpu_torch.graph import tick as T

    torch.set_num_threads(2)
    params, state, sdf = deploy.swarm_scenario(small_config(), SEED, device="cpu")
    state = T.run_ticks(state, sdf, params, 1)
    R = state.nbr_idx.shape[0]
    live = int(state.nbr_mask.sum())
    # every robot sends and every live slot is reciprocal: the reader's
    # count of live slots is the count delivered
    assert exchange_work.delivered_of(state) == live > 0
    off = dataclasses.replace(state, antenna=torch.arange(R) >= 1)
    assert exchange_work.delivered_of(off) == live - 2 * int(state.nbr_mask[0].sum())
    # the element sizes counted are the state's
    assert state.nbr_idx.element_size() == state.nbr_back.element_size() == 4
    assert state.ext_inbox.element_size() == state.ir_v2f_ext_pos.element_size() == 4
    assert state.iter_count_factor.element_size() == 4
    assert state.ir_int_seeded.element_size() == state.nbr_mask.element_size() == 1


# ---------------------------------------------------------------- readers

MS = 1_000_000


@pytest.fixture
def program(monkeypatch):
    """The program's profiling module with its newest map set by the test."""
    from magics_tpu_torch import profiling

    monkeypatch.setattr(profiling, "_newest_map", None)
    return profiling


def _replay(n):
    """A profiled replay of n operations, operation i taking i + 1 ms."""
    ops = [(f"k{i}", 20 * MS * i, 20 * MS * i + (i + 1) * MS, "kernel") for i in range(n)]
    return H.Trace(ops=ops, window_s=0.1, start_ns=0, end_ns=20 * MS * n)


def _outcome(replay=None, robots=4, degree=2.5):
    return H.Outcome(attempted=1, failed=0, traces={} if replay is None else {"replay": replay},
                     stats={"replay_ticks": 2},
                     notes=[{"mean_degree": degree, "robots": robots}])


def _map(program, parts=True):
    size = (4, 3, 2)
    names = program_parts.EXCHANGE
    found = [program.Part(n, 2 + i, 3 + i, size) for i, n in enumerate(names)]
    found += [program.Part(n, 7 + 2 * i, 9 + 2 * i, size) for i, n in enumerate(names)]
    return program.StageMap(("gbp.internal", "gbp.external"), (0, 2), 16,
                            tuple(found) if parts else ())


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_returns_none_without_the_marks(metric, program, monkeypatch):
    reader = H.reader(metric)
    assert reader.read(H.Outcome(attempted=0, failed=0)) is None
    # a replay and no map; a map whose exchange marked no part (the sender's)
    assert reader.read(_outcome(_replay(16))) is None
    program._newest_map = _map(program, parts=False)
    assert reader.read(_outcome(_replay(16))) is None
    # a replay the map does not fit
    program._newest_map = _map(program)
    assert reader.read(_outcome(_replay(17))) is None
    # a program whose profiling module predates part maps
    monkeypatch.setattr(program_parts, "_profiling", lambda: object())
    assert reader.read(_outcome(_replay(16))) is None


def test_the_readers_read_the_exchange_parts(program):
    program._newest_map = _map(program)
    out = _outcome(_replay(16))
    # parts: ops 2, 3, 4, 5 (3+4+5+6 ms) and 7-8, 9-10, 11-12, 13-14
    # (8+9 + 10+11 + 12+13 + 14+15 ms) over 2 ticks
    assert H.reader("exchange_ms.compact").read(out) == pytest.approx((18 + 92) / 2)
    assert H.reader("exchange_kernels.compact").read(out) == pytest.approx((4 + 8) / 2)
    from benchmark.rooflines import least_seconds

    least, _ = least_seconds(*exchange_work.exchange_work(4, 3, 2, 10))
    slot_s = (18 + 92) / 2 / 1e3
    assert H.reader("exchange_roofline.compact").read(out) == pytest.approx(
        100 * least / slot_s)
    # without the message line there is no count of the delivered slots
    out.notes = []
    assert H.reader("exchange_roofline.compact").read(out) is None

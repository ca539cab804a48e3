"""The port's robot-sharded tick (magics_tpu_torch/parallel/) on the CPU:
2 and 4 gloo ranks, each a fresh process (`spawn`) meeting at a file,
hold R / n of 16 robots and run `make_shard_step` with a `ShardComm`.

- Against the port's one-process tick, on the scenarios of
  tests/test_shard_tick.py (dense at comms failure 0.2; the hot-layout path
  of the kernels, their plain versions on the CPU; logs and goal areas; the
  grid with robot and environment collisions), receiver_compact and a
  dense circle whose robots collide, 5 ticks in
  float64: integer and bool fields exact, floats within rtol = atol =
  1e-12 (the JAX test's bound). Every rank seeds its comms-failure
  generator alike, so the failures do not depend on the sharding.
- Against the JAX package's shard_map tick on the conftest's 8 virtual CPU
  devices, from the same start (a perturbed circle, ROADMAP F2) with no
  comms failure, 1 tick in float64: discrete fields equal, float fields
  within 1e-8 of each vector's or matrix's own scale (test_torch_tick.py's
  bound for the one-process tick).
- The refusals: a capacity the ranks do not divide, the collision event
  rings on a sharded comm, and `compile_ticks` with a `ShardComm`.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_shard_cases as C
from magics_tpu.graph import tick as JT
from magics_tpu.parallel import shard_tick as JST
from magics_tpu.sim import builder as JB
from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.graph.chunk import compile_ticks
from magics_tpu_torch.kernels.gbp_slot import scaled_error
from magics_tpu_torch.parallel.comm import ShardComm
from magics_tpu_torch.parallel.launch import spawn_ranks
from magics_tpu_torch.parallel.shard_tick import (
    make_shard_step,
    shard_state,
    state_partition_specs,
)

RANKS = (2, 4)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{n: {case: final state as numpy arrays}} of the n-rank runs."""
    out = {}
    for n in RANKS:
        d = tmp_path_factory.mktemp(f"ranks{n}")
        spawn_ranks(C.run_cases, n, (str(d),), timeout=300)
        out[n] = {case: dict(np.load(d / f"{case}.npz"))
                  for case in (*C.CASES, *C.JAX_CASES)}
    return out


def _discrete(a: np.ndarray) -> bool:
    return a.dtype.kind in "biu"


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", sorted(C.CASES))
def test_sharded_port_equals_one_process(sharded, case, n):
    want = state_to_numpy(C.port_run(case))
    got = sharded[n][case]
    assert set(got) == set(want)
    bad = []
    for name, a in want.items():
        b = got[name]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{name}: {b.dtype}{b.shape} against {a.dtype}{a.shape}")
        elif _discrete(a):
            if not np.array_equal(a, b):
                bad.append(name)
        elif not np.allclose(b, a, rtol=1e-12, atol=1e-12, equal_nan=True):
            bad.append(f"{name}: max |d| {np.nanmax(np.abs(b - a)):.3g}")
    assert not bad, f"{n} ranks, {case}: {bad}"
    assert want["nbr_mask"].any()
    if case == "dense":
        assert not want["antenna"].all()                 # failures drawn
    if case == "logs_goal_areas":
        assert int(want["log_head"]) > 0 and (want["ga_history"] >= 0).any()
    if case in ("grid_env", "dense_collisions"):
        assert int(want["rr_collisions"]) > 0 and (want["rr_count"] > 0).all()
    if case == "grid_env":
        assert int(want["re_collisions"]) > 0


@pytest.fixture(scope="module")
def jax_sharded():
    """{case: final state} of the JAX shard_map tick on 8 CPU devices."""
    mesh = Mesh(np.array(jax.devices()), ("r",))
    repl = lambda x: jax.device_put(x, NamedSharding(mesh, P()))   # noqa: E731
    out = {}
    for case in C.JAX_CASES:
        params, state, sdf = C.build(JB, case, dtype=jax.numpy.float64)
        fn = JST.make_shard_step(mesh, params, C.R, n_ticks=C.n_ticks(case))
        final = fn(JST.shard_state(state, mesh), repl(sdf))
        out[case] = {f.name: np.asarray(getattr(final, f.name))
                     for f in dataclasses.fields(final)}
    return out


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", sorted(C.JAX_CASES))
def test_sharded_port_equals_jax_shard_map(sharded, jax_sharded, case, n):
    want, got = jax_sharded[case], sharded[n][case]
    assert set(got) == set(want) - {"rng"}
    assert got["nbr_mask"].any() and np.abs(got["ext_inbox"]).max() > 0
    for name, b in got.items():
        a = want[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if _discrete(a):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            err = scaled_error(name, torch.as_tensor(b), {name: torch.as_tensor(a)},
                               hot_layout=False)
            assert err <= 1e-8, (name, err)


def test_partition_specs_name_every_field():
    """Every field has a robot axis or is replicated, by name, as the JAX
    package lays out its own fields (its `rng` aside)."""
    specs = state_partition_specs()
    jax_specs = JST.state_partition_specs()
    assert set(specs) == {f.name for f in dataclasses.fields(jax_specs)} - {"rng"}
    for name, axis in specs.items():
        spec = tuple(getattr(jax_specs, name))
        assert axis == (spec.index("r") if "r" in spec else None), name
    params, state, _ = C.port_build("logs_goal_areas")
    part = shard_state(state, 1, 4)
    for name, axis in specs.items():
        full, mine = getattr(state, name), getattr(part, name)
        if axis is None:
            assert mine is full, name
        else:
            torch.testing.assert_close(mine, full.narrow(axis, 4, 4), rtol=0, atol=0,
                                       equal_nan=True, msg=name)
            assert mine.is_contiguous(), name


class _TwoShards:
    """A stand-in comm of rank 0 of two, whose other rank holds a copy of
    this one's robots: enough to reach the tick's refusals in one process."""

    n_shards, n_local = 2, C.R // 2

    def all_robots(self, arr):
        return torch.cat([arr, arr])

    def psum(self, x):
        return 2 * x

    def scatter_rows(self, arr):
        return self.take_rows(2 * arr, self.n_local)

    def row_ids(self, n_local, device=None):
        return torch.arange(n_local, dtype=torch.int32, device=device)

    def take_rows(self, arr, n_local):
        return arr[:n_local]


@pytest.mark.parametrize("ring", ["dense", "grid", "environment"])
def test_event_rings_refuse_a_sharded_comm(ring):
    grid = dict(grid_cell_size=15.0, grid_capacity=8, collision_partners=4,
                world=(120.0, 120.0)) if ring == "grid" else {}
    params, state, sdf = C.port_build("dense", collision_log_capacity=8, **grid)
    with pytest.raises(ValueError, match="collision_log_capacity"):
        make_shard_step(params, C.R, comm=ShardComm(2, C.R // 2, 0))
    comm = _TwoShards()
    one_process = state
    state = shard_state(state, 0, 2)
    match = "single-shard only"
    if ring == "dense":
        with pytest.raises(NotImplementedError, match=match):
            T.update_collisions(state, params, None, comm)
    elif ring == "grid":
        with pytest.raises(NotImplementedError, match=match):
            T.update_collisions_grid(state, params, None, comm)
    else:
        state = dataclasses.replace(state, rr_events=state.rr_events[:0])
        with pytest.raises(NotImplementedError, match=match):
            T._env_collision_updates(state, params, torch.zeros(16, 16, dtype=torch.float64),
                                     comm)
    # one process keeps the rings
    T.step(one_process, sdf, params, generator=torch.Generator().manual_seed(0))


def test_bad_capacity_and_compile_ticks_refuse():
    params, state, sdf = C.port_build("dense")
    with pytest.raises(ValueError, match="capacity"):
        make_shard_step(params, 10, comm=ShardComm(4, 2, 0))
    with pytest.raises(ValueError, match="capacity"):
        shard_state(state, 0, 3)
    with pytest.raises(ValueError, match="LOCAL comm"):
        compile_ticks(state, sdf, params, 2, comm=ShardComm(2, C.R // 2, 0))


def test_comm_row_layout_is_the_jax_one():
    """Robot r on rank r // n_local at local row r % n_local, the tiled
    all_gather order of the JAX ShardComm; LOCAL's rows start at 0."""
    from magics_tpu_torch.parallel.comm import LOCAL

    comm = ShardComm(n_shards=4, n_local=4, rank=2)
    assert comm.row_offset() == 8 and LOCAL.row_offset() == 0
    assert comm.row_ids(4).tolist() == [8, 9, 10, 11]
    assert comm.take_rows(torch.arange(16), 4).tolist() == [8, 9, 10, 11]
    assert comm == ShardComm(4, 4, 2, group=object())       # the group is not compared
    with pytest.raises(dataclasses.FrozenInstanceError):
        comm.rank = 0

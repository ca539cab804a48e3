"""The state and parameter bridge (magics_tpu_torch/convert.py), the port's
scenario builder against magics_tpu's, the port's independence from JAX, the
sender and receiver exchanges running, and the configurations the first
slices refused (the grid path, `scan_schedule`, the collision event
records): they run now, and only an unknown exchange raises."""

from __future__ import annotations

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.sim import builder as JB
from magics_tpu_torch import convert
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.sim import builder as TB

REPO = Path(__file__).resolve().parents[1]


def _kw(dtype, **extra):
    return dict(
        target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=22.0,
        comms_failure_rate=0.0, internal=4, external=3, n_slots=6, dtype=dtype,
        goal_areas=np.array([[-5.0, -5.0, 5.0, 5.0]]), **extra,
    )


def _jax_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.float64])
def test_state_round_trip_is_bit_equal(jdtype):
    specs = JB.circle_formation(10, circle_radius=18.0, target_speed=8.0)
    _, state, _ = JB.build_scenario(specs, **_kw(jdtype, log_capacity=3, log_every=1))
    arrays = _jax_numpy(state)
    back = convert.state_to_numpy(convert.state_from_numpy(arrays, device="cpu"))
    assert set(back) == set(arrays) - convert.DROPPED_FIELDS
    for name, a in back.items():
        assert a.dtype == arrays[name].dtype, name
        np.testing.assert_array_equal(a, arrays[name], err_msg=name)


def test_state_from_numpy_rejects_unknown_and_missing_fields():
    specs = JB.circle_formation(4, circle_radius=18.0, target_speed=8.0)
    arrays = _jax_numpy(JB.build_scenario(specs, **_kw(jnp.float32))[1])
    with pytest.raises(ValueError):
        convert.state_from_numpy({**arrays, "bogus": np.zeros(1)}, device="cpu")
    del arrays["pos"]
    with pytest.raises(ValueError):
        convert.state_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize(
    "jdtype, tdtype", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
)
def test_build_scenario_matches_jax_field_by_field(jdtype, tdtype):
    jspecs = JB.circle_formation(10, circle_radius=18.0, target_speed=8.0)
    tspecs = TB.circle_formation(10, circle_radius=18.0, target_speed=8.0)
    for specs in (jspecs, tspecs):
        specs[3].spawn_tick = 4
        specs[5].radius = 1.5
    jp, js, jsdf = JB.build_scenario(
        jspecs, **_kw(jdtype, sdf=np.linspace(0, 1, 64).reshape(8, 8), capacity=12)
    )
    tp, ts, tsdf = TB.build_scenario(
        tspecs, device="cpu",
        **_kw(tdtype, sdf=np.linspace(0, 1, 64).reshape(8, 8), capacity=12),
    )
    # the port's use_pallas defaults to None (kernels on CUDA only); the
    # bridge keeps the JAX value
    assert tp.use_pallas is None
    assert convert.params_from_jax(jp) == dataclasses.replace(tp, use_pallas=jp.use_pallas)
    np.testing.assert_array_equal(np.asarray(jsdf), tsdf.numpy())
    jarr, tarr = _jax_numpy(js), convert.state_to_numpy(ts)
    assert set(tarr) == set(jarr) - {"rng"}
    for name, t in tarr.items():
        assert t.dtype == jarr[name].dtype, name
        np.testing.assert_array_equal(t, jarr[name], err_msg=name)


def test_port_imports_no_jax():
    modules = sorted(
        m.name
        for m in pkgutil.walk_packages([str(REPO / "magics_tpu_torch")], "magics_tpu_torch.")
    )
    code = (
        "import importlib, sys\n"
        "import magics_tpu_torch.graph.tick, magics_tpu_torch.kernels.hot\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "magics_tpu_torch.kernels.gbp_slot" in modules


UNPORTED = {
    "grid": dict(ext_exchange="receiver_compact", grid_cell_size=15.0),
    "scan_schedule": dict(ext_exchange="receiver_compact", scan_schedule=True),
    "collision_log": dict(ext_exchange="receiver_compact", collision_log_capacity=8),
}


@pytest.mark.parametrize("config", sorted(UNPORTED))
def test_unported_configurations_raise(config):
    """The configurations the first slices refused with NotImplementedError
    run now (tests/test_torch_grid.py holds them against the JAX package):
    2 ticks leave a finite state in which the robots moved. Only a name the
    port does not know raises."""
    specs = TB.circle_formation(6, circle_radius=5.0, target_speed=8.0)
    params, state, sdf = TB.build_scenario(
        specs, device="cpu", **_kw(torch.float32, **UNPORTED[config])
    )
    out = TT.run_ticks(state, sdf, params, 2)
    for name, x in convert.state_to_numpy(out).items():
        if x.dtype.kind == "f" and name not in ("pos_log", "vel_log"):
            assert np.isfinite(x).all(), name
    assert np.abs(out.pos.numpy() - state.pos.numpy()).max() > 0.1
    with pytest.raises(ValueError, match="ext_exchange"):
        dataclasses.replace(params, ext_exchange="broadcast")


EXCHANGES = {
    "sender": dict(ext_exchange="sender"),
    "receiver": dict(ext_exchange="receiver"),
    "sender_hot": dict(ext_exchange="sender", use_pallas=True),
    "receiver_hot": dict(ext_exchange="receiver", use_pallas=True),
}


@pytest.mark.parametrize("config", sorted(EXCHANGES))
def test_exchange_configurations_run(config):
    """The sender and plain receiver exchanges, plain and hot: 2 ticks leave
    a finite state in which the robots moved."""
    specs = TB.circle_formation(6, circle_radius=5.0, target_speed=8.0)
    params, state, sdf = TB.build_scenario(
        specs, device="cpu", **_kw(torch.float32, **EXCHANGES[config])
    )
    out = TT.run_ticks(state, sdf, params, 2)
    for name, x in convert.state_to_numpy(out).items():
        if x.dtype.kind == "f":
            assert np.isfinite(x).all(), name
    assert np.abs(out.pos.numpy() - state.pos.numpy()).max() > 0.1
    assert bool(out.nbr_mask.any())


def test_comms_failure_needs_a_generator_and_uses_it():
    specs = TB.circle_formation(6, circle_radius=5.0, target_speed=8.0)
    kw = _kw(torch.float32, ext_exchange="receiver_compact")
    kw["comms_failure_rate"] = 1.0
    params, state, sdf = TB.build_scenario(specs, device="cpu", **kw)
    with pytest.raises(ValueError):
        TT.step(state, sdf, params)
    out = TT.step(state, sdf, params, generator=torch.Generator().manual_seed(0))
    assert not out.antenna.any()   # rate 1: every antenna fails
    assert int(out.msg_counts[:, 1].sum()) == 0   # so no external messages

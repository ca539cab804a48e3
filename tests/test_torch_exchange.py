"""The port's "sender" and plain "receiver" inter-robot exchanges
(magics_tpu_torch/graph/tick.py) against magics_tpu's, on
test_torch_tick.py's scaled-down bench workload (a 16-robot crossing, K=8,
6 internal + 3 external slots per tick, tracking off), and the port's
receiver against its own sender (magics_tpu's test_receiver_exact_bit_parity).

The JAX package runs with `use_pallas=False` under `jax.jit`; the port runs
both its hot-layout path (`use_pallas=True`, the card's path, whose kernel
wrappers take their plain versions on the CPU) and its plain passes.
Tolerances: one float64 tick within 1e-8 of each vector's or matrix's own
scale, discrete fields equal (test_torch_tick.py's rule); 20 float32 ticks
within 2.0 m (test_pallas_slot.py's bound).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tick import EXACT, FIELD_GROUPS, _err, _specs

from magics_tpu.core.schedule import ScheduleKind
from magics_tpu.graph import tick as JT
from magics_tpu.sim import builder as JB
from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.sim import builder as TB

EXCHANGES = ("sender", "receiver")
GROUPS = {**FIELD_GROUPS, "inter_robot": ("ir_v2f_ext_pos", "ext_inbox", "ir_f2v_ext")}


def _kw(dtype, exchange):
    return dict(
        target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
        internal=6, external=3, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=dtype,
        despawn_on_final_waypoint=False, tracking_enabled=False, ext_exchange=exchange,
    )


def _jax_run(n: int, dtype, exchange: str) -> dict:
    params, state, sdf = JB.build_scenario(_specs(JB), **_kw(dtype, exchange))
    final = jax.jit(partial(JT.run_ticks, n=n), static_argnums=2)(state, sdf, params)
    return {f.name: np.asarray(getattr(final, f.name)) for f in dataclasses.fields(final)}


def _port_run(n: int, dtype, exchange: str, use_pallas: bool):
    params, state, sdf = TB.build_scenario(
        _specs(TB), use_pallas=use_pallas, device="cpu", **_kw(dtype, exchange)
    )
    return state_to_numpy(TT.run_ticks(state, sdf, params, n)), state_to_numpy(state)


@pytest.fixture(scope="module")
def one_tick_f64():
    """{(exchange, path): (JAX state, port state)} after one float64 tick."""
    out = {}
    for exchange in EXCHANGES:
        want = _jax_run(1, jnp.float64, exchange)
        for path, use_pallas in (("hot", True), ("plain", False)):
            out[exchange, path] = want, _port_run(1, torch.float64, exchange, use_pallas)[0]
    return out


CASES = [(e, p) for e in EXCHANGES for p in ("hot", "plain")]


@pytest.mark.parametrize("exchange, path", CASES)
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_one_tick_float64_fields_match(one_tick_f64, exchange, path, group):
    jax_s, port_s = one_tick_f64[exchange, path]
    for name in GROUPS[group]:
        assert jax_s[name].shape == port_s[name].shape, name
        assert _err(name, jax_s, port_s) <= 1e-8, (name, _err(name, jax_s, port_s))


@pytest.mark.parametrize("exchange, path", CASES)
def test_one_tick_float64_discrete_and_remaining_fields(one_tick_f64, exchange, path):
    jax_s, port_s = one_tick_f64[exchange, path]
    assert set(port_s) == set(jax_s) - {"rng"}
    for name in EXACT:
        np.testing.assert_array_equal(jax_s[name], port_s[name], err_msg=name)
    for name in set(port_s) - set(EXACT).union(*GROUPS.values()):
        a, b = jax_s[name], port_s[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert _err(name, jax_s, port_s) <= 1e-8, (name, _err(name, jax_s, port_s))
    assert port_s["nbr_mask"].any() and np.abs(port_s["ext_inbox"]).max() > 0.0
    if exchange == "sender":
        assert np.abs(port_s["ir_f2v_ext"]).max() > 0.0       # the outboxes were written


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_twenty_ticks_float32_trajectories_agree(exchange):
    jax_s = _jax_run(20, jnp.float32, exchange)
    port_s, start = _port_run(20, torch.float32, exchange, use_pallas=True)
    assert np.isfinite(port_s["pos"]).all()
    assert np.abs(port_s["pos"] - start["pos"]).max() > 1.0
    assert np.abs(port_s["ext_inbox"]).max() > 0.0
    assert np.abs(jax_s["pos"] - port_s["pos"]).max() < 2.0


# fields whose meaning differs by exchange (magics_tpu graph/state.py): the
# receiver's positions and seeded flags mirror the peer's, and it keeps no
# outbox
MODE_PRIVATE = {"ir_v2f_ext_pos", "ir_int_seeded", "ir_f2v_ext"}


def test_receiver_bit_equal_to_sender():
    """magics_tpu's test_receiver_exact_bit_parity on the port: 12 robots,
    K=6 below the degree (slot churn and overflow), comms failure 0.3 drawn
    from one seeded generator per run, 45 float64 ticks of the plain
    passes. The receiver recomputes each inbox with the sender's arithmetic
    on the same operands, so every shared field is bit-equal at every tick."""
    runs = {}
    for exchange in EXCHANGES:
        specs = TB.circle_formation(12, circle_radius=18.0, target_speed=8.0)
        runs[exchange] = TB.build_scenario(
            specs, target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=22.0,
            comms_failure_rate=0.3, internal=4, external=3, n_slots=6,
            dtype=torch.float64, ext_exchange=exchange, device="cpu",
        ) + (torch.Generator().manual_seed(7),)
    (pa, sa, sdf, ga), (pb, sb, _, gb) = runs["sender"], runs["receiver"]
    failed = 0
    for t in range(45):
        sa = TT.step(sa, sdf, pa, generator=ga)
        sb = TT.step(sb, sdf, pb, generator=gb)
        a, b = state_to_numpy(sa), state_to_numpy(sb)
        for name in set(a) - MODE_PRIVATE:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"tick {t} field {name}")
        failed += int((~a["antenna"]).sum())
    assert failed > 0                                   # the failures happened
    assert np.abs(a["ext_inbox"]).sum() > 0.0           # and so did the exchange
    assert int(a["nbr_overflow"]) > 0                   # K below the degree

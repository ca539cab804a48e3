"""The sender exchange's message table (magics_tpu_torch/kernels/ir_slot.py)
against magics_tpu's Pallas kernel `interrobot_messages_pallas` (in
interpret mode) and its XLA message maths, on test_ir_slot.py's evolved
sender state: 12 robots after 6 ticks with live neighbour slots and skip
conditions, every third robot's even chain positions unseeded (the
empty-cavity guard). The JAX state crosses over through numpy
(`convert.state_from_numpy`).

On CPU tensors the port's wrapper runs its plain version, which calls
`factors.interrobot_rank1_messages`. Tolerances are test_ir_slot.py's:
float64 within 1e-12; float32 within 2e-5 with an equal zero pattern (the
same guard decisions).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ir_slot import _evolved_state, _xla_messages

from magics_tpu.kernels.ir_slot import interrobot_messages_pallas
from magics_tpu_torch import convert
from magics_tpu_torch.graph.exchange import sender_gate, sender_inputs
from magics_tpu_torch.kernels import ir_slot as IR

TOL = {jnp.float64: dict(rtol=1e-12, atol=1e-12), jnp.float32: dict(rtol=2e-5, atol=2e-5)}


@pytest.fixture(scope="module", params=[jnp.float64, jnp.float32], ids=["f64", "f32"])
def evolved(request):
    jparams, jstate = _evolved_state(request.param)
    arrays = {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    return request.param, jparams, jstate, convert.params_from_jax(jparams), convert.state_from_numpy(arrays, device="cpu")


def _take_all(tstate) -> dict:
    """The select's inputs that take every factor: every gate and slot on,
    an old outbox of NaNs that no entry keeps."""
    R, K = tstate.nbr_mask.shape
    return dict(old=torch.full_like(tstate.ir_f2v_ext, float("nan")),
                send_gate=torch.ones(R, dtype=torch.bool),
                nbr_mask=torch.ones(R, K, dtype=torch.bool))


def _messages(tparams, tstate) -> torch.Tensor:
    """The sender exchange's message table of a state, every factor
    taken, through the wrapper."""
    return IR.interrobot_slot(**sender_inputs(tstate, tparams),
                              sigma=tparams.sigma_factor_interrobot, **_take_all(tstate))


def _port_table(tparams, tstate) -> np.ndarray:
    before = dict(IR.launch_counts)
    msg = _messages(tparams, tstate)
    assert IR.launch_counts == before   # the CPU runs the plain version, no launch
    return msg.numpy()


def test_plain_version_matches_pallas_kernel(evolved):
    jdtype, jparams, jstate, tparams, tstate = evolved
    want = np.asarray(interrobot_messages_pallas(jstate, jparams, r_tile=4, interpret=True))
    got = _port_table(tparams, tstate)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[jdtype])
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    s = want[..., 3]
    assert (s != 0).any() and (s == 0).any()   # live and empty messages both


def test_plain_version_matches_xla_maths(evolved):
    jdtype, jparams, jstate, tparams, tstate = evolved
    want = np.asarray(jax.jit(_xla_messages, static_argnums=1)(jstate, jparams))
    got = _port_table(tparams, tstate)
    np.testing.assert_allclose(got, want, **TOL[jdtype])
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def test_unseeded_slots_emit_nothing_but_skips(evolved):
    """An unseeded slot's cavity is empty, so M = alpha g g^T has rank at
    most 1 and the det guard empties the message."""
    _, _, _, tparams, tstate = evolved
    msg = _messages(tparams, tstate)
    unseeded = ~tstate.ir_int_seeded & tstate.nbr_mask[..., None]
    assert bool(unseeded.any())
    assert bool((msg[unseeded] == 0).all())


def test_wrapper_refuses_other_devices(evolved):
    _, _, _, tparams, tstate = evolved
    inputs = {k: v.to("meta") for k, v in {**sender_inputs(tstate, tparams),
                                           **_take_all(tstate)}.items()}
    with pytest.raises(ValueError, match="device"):
        IR.interrobot_slot(**inputs, sigma=tparams.sigma_factor_interrobot)


def _select_inputs(tstate, seed: int):
    """An old outbox with a NaN in every third entry, and a send gate and a
    live-slot mask that leave some robots wholly taken, some wholly kept."""
    g = torch.Generator().manual_seed(seed)
    R, K = tstate.nbr_mask.shape
    old = torch.randn(tstate.ir_f2v_ext.shape, generator=g, dtype=tstate.ir_f2v_ext.dtype)
    old.view(-1)[::3] = float("nan")
    gate = torch.rand(R, generator=g) > 0.3
    gate[::4] = False
    mask = tstate.nbr_mask.clone()
    mask[1::3] = True
    return old, gate, mask


def test_select_is_the_where_it_replaces(evolved):
    """With the old outbox, the send gates and the live-slot mask the
    wrapper gives the sender exchange's select, `where(gate & mask, table,
    old)`, bit for bit (NaNs of the old outbox included); the plain version
    is that select on the CPU, as the kernel is on the card."""
    _, _, _, tparams, tstate = evolved
    old, gate, mask = _select_inputs(tstate, 1)
    table = _messages(tparams, tstate)
    before = dict(IR.launch_counts)
    got = IR.interrobot_slot(**sender_inputs(tstate, tparams),
                             sigma=tparams.sigma_factor_interrobot,
                             old=old, send_gate=gate, nbr_mask=mask)
    assert IR.launch_counts == before
    want = torch.where((gate[:, None] & mask)[..., None, None], table, old)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    taken = (gate[:, None] & mask)
    assert bool(taken.any()) and bool((~taken).any())
    assert bool((table[taken] != 0).any())              # live messages taken


PATTERNS = {
    # (send gate, live-slot mask, old outbox) as functions of (state, seed)
    "all taken": lambda st, g: (True, True, None),
    "none taken": lambda st, g: (False, True, None),
    "gates only": lambda st, g: (torch.rand(st.nbr_mask.shape[0], generator=g) > 0.5, True, None),
    "slots only": lambda st, g: (True, torch.rand(st.nbr_mask.shape, generator=g) > 0.5, None),
    "the state's own": lambda st, g: (sender_gate(st), st.nbr_mask, st.ir_f2v_ext),
}


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_select_is_the_where_for_each_pattern(evolved, pattern):
    """The plain version keeps the old outbox bit for bit where the gate or
    the slot is off, and gives the table elsewhere: with every factor taken,
    with none, with only the gates or only the slots mixed, and with the
    state's own send gates, live slots and outbox, as the exchange calls it."""
    _, _, _, tparams, tstate = evolved
    R, K = tstate.nbr_mask.shape
    gate, mask, old = PATTERNS[pattern](tstate, torch.Generator().manual_seed(3))
    gate = torch.full((R,), gate) if isinstance(gate, bool) else gate
    mask = torch.full((R, K), mask) if isinstance(mask, bool) else mask
    old = _select_inputs(tstate, 3)[0] if old is None else old
    got = IR.interrobot_slot(**sender_inputs(tstate, tparams),
                             sigma=tparams.sigma_factor_interrobot,
                             old=old, send_gate=gate, nbr_mask=mask)
    taken = (gate[:, None] & mask)[..., None, None]
    want = torch.where(taken, _messages(tparams, tstate), old)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    if pattern == "none taken":
        assert torch.equal(got.view(torch.uint8), old.view(torch.uint8))

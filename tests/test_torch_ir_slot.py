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
from magics_tpu_torch.graph.exchange import sender_inputs
from magics_tpu_torch.kernels import ir_slot as IR

TOL = {jnp.float64: dict(rtol=1e-12, atol=1e-12), jnp.float32: dict(rtol=2e-5, atol=2e-5)}


@pytest.fixture(scope="module", params=[jnp.float64, jnp.float32], ids=["f64", "f32"])
def evolved(request):
    jparams, jstate = _evolved_state(request.param)
    arrays = {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    return request.param, jparams, jstate, convert.params_from_jax(jparams), convert.state_from_numpy(arrays, device="cpu")


def _messages(tparams, tstate) -> torch.Tensor:
    """The sender exchange's message table of a state, through the wrapper."""
    return IR.interrobot_slot(**sender_inputs(tstate, tparams),
                              sigma=tparams.sigma_factor_interrobot)


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
    inputs = {k: v.to("meta") for k, v in sender_inputs(tstate, tparams).items()}
    with pytest.raises(ValueError, match="device"):
        IR.interrobot_slot(**inputs, sigma=tparams.sigma_factor_interrobot)

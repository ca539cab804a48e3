"""The compact exchange's plain versions (magics_tpu_torch/kernels/
compact_exchange.py, what the wrappers run on CPU tensors) against
magics_tpu's graph/factors.py `compact_snap_tables` and
`interrobot_rank1_messages_compact`, composed as magics_tpu's
tick.py:_external_factor_pass_receiver composes them, on seeded inputs
with mixed gates, unseeded mirrors, empty and non-reciprocal slots,
singular, non-finite and broad cavities, skipped and negligible factors
(chip_smoke.compact_inputs, which the card's tests share): each table
entry and inbox row within rtol of its own scale, max(|row|, 1), 1e-9 in
float64 and 2e-3 in float32, no message empty in one and not the other,
discrete outputs equal. In float32 both frameworks stray from the float64
result by up to 5.5e-4 of scale on these inputs' ill-conditioned cavities
(the 4x4 inverse amplifies roundoff, and XLA fuses and orders its float
operations its own way), and from each other by up to 5.2e-4. Then the kernels' path of one tick's
exchange on the CPU bit-equal to the plain path (graph/exchange.py), and the
wrappers refusing a device without the kernels, a wrong dtype or shape.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_exchange import _kw, _specs

from magics_tpu.graph import factors as JF
from magics_tpu_torch.graph import gbp as GBP
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.kernels import compact_exchange as CX
from magics_tpu_torch.sim import builder as TB


def _smoke():
    """chip_smoke.py, whose seeded inputs the card's tests share."""
    if "chip_smoke" not in sys.modules:
        path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["chip_smoke"] = module
    return sys.modules["chip_smoke"]


def _inputs(R, K, V, dtype, seed=0, gates="mixed"):
    return _smoke().compact_inputs(torch, R, K, V, seed=seed, gates=gates, device="cpu",
                                   dtype=dtype)


def _jax_exchange(tables, messages, f):
    """magics_tpu's receiver_compact exchange of one slot (tick.py:
    _external_factor_pass_receiver, its XLA branch), from its factor
    functions: (tables, gate, counter, inbox)."""
    arrays = {k: jnp.asarray(v.numpy()) for k, v in messages.items()
              if isinstance(v, torch.Tensor)}
    mult, sigma = messages["safety_multiplier"], messages["sigma"]

    def run(snap_mu, snap_eta, snap_lam, active, antenna, mission, completed, count, m):
        R, K = m["nbr_idx"].shape
        V1 = snap_mu.shape[1] - 1
        gate = active & antenna & (mission | completed)
        src = jnp.clip(m["nbr_idx"], 0, R - 1)
        deliver = gate[:, None] & m["nbr_mask"] & gate[src] & m["nbr_has_back"]
        tiny = jnp.asarray(1e-6, f) * (src.astype(f)[..., None] * (K * V1)
                                       + m["nbr_back"].astype(f)[..., None] * V1
                                       + jnp.arange(V1, dtype=f) + 1.0)
        safety = jnp.broadcast_to((mult * m["radius_all"][src])[..., None], (R, K, V1))
        tab = JF.compact_snap_tables(snap_mu, snap_eta, snap_lam, dtype=f)
        msg = JF.interrobot_rank1_messages_compact(
            tab[src], m["seeded"], m["p_ext"], safety, tiny, sigma, dtype=f)
        inbox = jnp.where(deliver[..., None, None], msg, m["ext_inbox"])
        return tab, gate, count + gate.astype(jnp.int32), inbox

    out = jax.jit(run)(*(jnp.asarray(x.numpy()) for x in tables), arrays)
    return [np.asarray(x) for x in out]


def _exchange(tables, messages):
    """The wrappers' exchange of one slot: (tables, gate, counter, inbox)."""
    tab, gate, count = CX.compact_tables(*tables)
    inbox = CX.compact_messages(tab, gate, gate, **messages)
    return tab, gate, count, inbox


def _row_scale(x: np.ndarray) -> np.ndarray:
    """max(|x| over the last axis, 1) of each row, kept for broadcasting."""
    return np.maximum(np.abs(x).max(axis=-1, keepdims=True, initial=0.0), 1.0)


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-9), (torch.float32, 2e-3)])
@pytest.mark.parametrize("R, K, V, gates", [
    (37, 6, 9, "mixed"), (50, 49, 21, "mixed"), (24, 8, 5, "on"), (9, 3, 4, "off"),
])
def test_plain_exchange_matches_jax(dtype, rtol, R, K, V, gates):
    tables, messages = _inputs(R, K, V, dtype, seed=R * K + V, gates=gates)
    f = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = _jax_exchange(tables, messages, f)
    before = dict(CX.launch_counts)
    got = [x.numpy() for x in _exchange(tables, messages)]
    assert CX.launch_counts == before   # the CPU runs the plain versions, no launch
    names = ("tables", "gate", "counter", "inbox")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for name, g, w in (("tables", got[0], want[0]), ("inbox", got[3], want[3])):
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        g, w = np.nan_to_num(g.astype(np.float64)), np.nan_to_num(w.astype(np.float64))
        err = np.abs(g - w) / _row_scale(w)
        assert err.max(initial=0.0) <= rtol, (name, float(err.max()))
    np.testing.assert_array_equal(got[3][..., 3] == 0, want[3][..., 3] == 0)
    # the inputs hold every case: valid and invalid tables, gated-off robots
    # (but with the gates all off), delivered live and empty messages,
    # kept old rows
    valid = want[0][..., 7]
    assert (valid == 1).any() and (valid == 0).any()
    inbox, old = want[3], messages["ext_inbox"].numpy()
    kept = (inbox == old).all(axis=-1)
    if gates == "off":
        assert kept.all() and not want[1].any()
        return
    live = inbox[..., 3] != 0
    assert (live & ~kept).any() and (~live & ~kept).any() and kept.any()


def test_inputs_hold_skipped_and_negligible_factors():
    """Among the delivered slots of the mixed inputs at the Circle's shape:
    factors beyond the safety distance (skipped), within it and valid, and
    within it on a broad cavity whose message is negligible (empty)."""
    tables, messages = _inputs(50, 49, 21, torch.float64, seed=50 * 49 + 21)
    tab, gate, _, inbox = _exchange(tables, messages)
    src = messages["nbr_idx"].clamp(0, 49).long()
    deliver = (gate[:, None] & messages["nbr_mask"] & gate[src] & messages["nbr_has_back"])
    d = tab[src][..., 0:2] - messages["p_ext"]
    safety = 2.2 * messages["radius_all"][src][..., None]
    within = (d * d).sum(-1) < safety * safety
    usable = deliver[..., None] & messages["seeded"] & (tab[src][..., 7] > 0.5)
    live = inbox[..., 3] != 0
    assert (usable & ~within).any()               # skipped
    assert (usable & within & live).any()         # a message
    assert (usable & within & ~live).any()        # negligible


def _pass_state(seed: int):
    """test_torch_exchange's crossing under receiver_compact after 4 plain
    float32 ticks on the CPU, with seeded gates, mirrors and an old inbox
    put in, and the params."""
    params, state, sdf = TB.build_scenario(
        _specs(TB), use_pallas=False, device="cpu", **_kw(torch.float32, "receiver_compact"))
    state = T.run_ticks(state, sdf, params, 4)
    g = torch.Generator().manual_seed(seed)
    R, K, V1 = state.ir_int_seeded.shape
    state = dataclasses.replace(
        state,
        antenna=torch.rand(R, generator=g) < 0.8,
        mission_active=state.mission_active & (torch.rand(R, generator=g) < 0.9),
        ir_int_seeded=torch.rand((R, K, V1), generator=g) < 0.8,
        ext_inbox=torch.randn((R, K, V1, 4), generator=g),
    )
    return params, state


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_path_pass_bit_equal_to_plain_pass(seed):
    """The exchange's pass on the kernels' path (the wrappers: their plain
    versions on the CPU) against its plain path (the row gather and the
    plain maths): every field bit for bit, some messages live."""
    params, state = _pass_state(seed)
    got = GBP.external_factor_pass(state, params, kernels=True)
    want = GBP.external_factor_pass(state, params)
    assert not _smoke().differing_fields(torch, got, want)
    assert not torch.equal(want.ext_inbox, state.ext_inbox)
    assert torch.equal(want.iter_count_factor - state.iter_count_factor,
                       (state.active & state.antenna
                        & (state.mission_active | state.completed)).int())


def _args():
    tables, messages = _inputs(11, 4, 6, torch.float32, seed=5)
    tab, gate, _ = CX.compact_tables_reference(*tables)
    return tables, dict(tables_all=tab, gate=gate, gate_all=gate, **messages)


@pytest.mark.parametrize("fault", ["device", "dtype", "mixed dtype", "shape"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fault):
    tables, messages = _args()
    if fault == "device":
        tables = tuple(x.to("meta") for x in tables)
        messages = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                    for k, v in messages.items()}
    elif fault == "dtype":
        tables = (*tables[:3], tables[3].int(), *tables[4:])            # active not bool
        messages["nbr_idx"] = messages["nbr_idx"].long()
    elif fault == "mixed dtype":
        tables = (tables[0], tables[1].double(), *tables[2:])
        messages["radius_all"] = messages["radius_all"].double()
    else:
        tables = (*tables[:7], tables[7][:-1])                          # counter short
        messages["p_ext"] = messages["p_ext"][:, :, :-1]
    before = dict(CX.launch_counts)
    with pytest.raises((ValueError, TypeError)):
        CX.compact_tables(*tables)
    with pytest.raises((ValueError, TypeError)):
        CX.compact_messages(**messages)
    assert CX.launch_counts == before


def test_kernel_path_hands_the_kernels_contiguous_inputs():
    """Three ticks of the kernels' path (`use_pallas=True`; the CPU runs the
    plain versions) leave every state field the compact exchange's kernels
    read contiguous, as their wrappers require on the card: the mirrored
    positions among them, which the hot loop forms from a view of its
    robots-last planes."""
    params, state, sdf = TB.build_scenario(
        _specs(TB), use_pallas=True, device="cpu", **_kw(torch.float32, "receiver_compact"))
    state = T.run_ticks(state, sdf, params, 3)
    read = ("snap_mu", "snap_eta", "snap_lam", "active", "antenna", "mission_active",
            "completed", "iter_count_factor", "radius", "nbr_idx", "nbr_back", "nbr_mask",
            "nbr_has_back", "ir_int_seeded", "ir_v2f_ext_pos", "ext_inbox")
    assert [n for n in read if not getattr(state, n).is_contiguous()] == []

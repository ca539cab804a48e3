"""The chunk runner (magics_tpu_torch/graph/chunk.py) as far as the CPU can
hold it: `copy_state_` keeps every tensor's storage and copies aliased
fields right, `compile_ticks` refuses a state off the card, and a tick
makes no host-to-device copy and reads no tensor on the host (what a
CUDA graph capture forbids), on the dense and grid paths, with the logs,
event records, environment collisions and comms-failure draws on. The
captures themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from magics_tpu_torch.core.timesteps import device_timesteps
from magics_tpu_torch.graph import chunk as C
from magics_tpu_torch.graph import tick as TT
from magics_tpu_torch.sim import builder as TB


def _scenario(**extra):
    specs = TB.circle_formation(12, circle_radius=18.0, target_speed=8.0)
    for i, s in enumerate(specs):
        s.start[:2] *= 1.0 + 0.01 * i
        s.waypoints[0, :2] *= 1.0 + 0.01 * i
    return TB.build_scenario(
        specs, target_speed=8.0, planning_horizon=2.0, hz=10.0, comms_radius=22.0,
        internal=4, external=3, n_slots=6, dtype=torch.float32, device="cpu", **extra,
    )


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def test_copy_state_keeps_storage_and_equals_source():
    params, state, sdf = _scenario(log_every=1, log_capacity=3)
    src = TT.run_ticks(state, sdf, params, 2)
    dst = C.clone_state(state)
    ptrs = {n: x.data_ptr() for n, x in _fields(dst).items()}
    assert C.copy_state_(dst, src) is dst
    for n, x in _fields(dst).items():
        assert x.data_ptr() == ptrs[n], n
        assert torch.equal(x.nan_to_num(), getattr(src, n).nan_to_num()), n
    assert int(dst.tick) == 2 and not torch.equal(dst.pos, state.pos)


def test_copy_state_copies_aliased_fields_first():
    """A source field that is (a view of) another destination field's tensor
    is read before that field is overwritten."""
    params, state, sdf = _scenario()
    dst = C.clone_state(TT.step(state, sdf, params))
    old_belief = dst.belief_mean.clone()
    src = dataclasses.replace(
        C.clone_state(state), snap_mu=dst.belief_mean, snap_eta=dst.snap_eta,
    )
    C.copy_state_(dst, src)
    assert torch.equal(dst.snap_mu, old_belief)          # read before belief_mean was copied
    assert torch.equal(dst.belief_mean, state.belief_mean)
    with pytest.raises(ValueError, match="does not fit"):
        C.copy_state_(dst, dataclasses.replace(src, pos=src.pos[:3]))


def test_compile_ticks_refuses_a_cpu_state():
    params, state, sdf = _scenario()
    with pytest.raises(RuntimeError, match="cuda"):
        C.compile_ticks(state, sdf, params, 2)


def test_cached_timesteps_outlive_other_keys():
    """The timesteps tensor a captured chunk reads on every replay stays the
    same tensor however many other (timesteps, dtype, device) keys come
    after it."""
    params, state, _ = _scenario()
    first = device_timesteps(params, state.t0.dtype, state.device)
    for k in range(100):
        other = dataclasses.replace(params, variable_timesteps=tuple(range(k + 2)))
        device_timesteps(other, torch.float64, state.device)
    assert device_timesteps(params, state.t0.dtype, state.device) is first


def _forbid_host_traffic(monkeypatch):
    """Make every host-to-device copy of a constant and every host read of
    a tensor raise."""
    def refuse(name):
        def f(*args, **kwargs):
            raise AssertionError(f"{name} inside a tick: not capturable")
        return f

    monkeypatch.setattr(torch, "tensor", refuse("torch.tensor"))
    monkeypatch.setattr(torch, "as_tensor", refuse("torch.as_tensor"))
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))


CONFIGS = {
    "dense_sender_hot": dict(ext_exchange="sender", use_pallas=True),
    "dense_receiver_plain": dict(ext_exchange="receiver", use_pallas=False),
    "grid_compact_hot": dict(ext_exchange="receiver_compact", use_pallas=True,
                             grid_cell_size=10.0, grid_capacity=16, collision_partners=8),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_tick_makes_no_host_traffic(config, monkeypatch):
    params, state, sdf = _scenario(
        comms_failure_rate=0.3, log_every=2, log_capacity=3, viz_log_capacity=2,
        collision_log_capacity=8, **CONFIGS[config],
    )
    env = torch.as_tensor(np.random.default_rng(0).uniform(0.0, 3.0, size=(16, 16)))
    gen = torch.Generator().manual_seed(3)
    state = TT.step(state, sdf, params, env, generator=gen)   # caches the constants
    _forbid_host_traffic(monkeypatch)
    out = TT.run_ticks(state, sdf, params, 3, env, generator=gen)
    monkeypatch.undo()
    assert int(out.tick) == 4 and bool(out.nbr_mask.any())
    assert not bool(out.antenna.all())       # the draws ran

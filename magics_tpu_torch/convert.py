"""State and parameter bridge between magics_tpu and the port, through numpy.

The port never imports JAX: a caller holding a JAX `SimState` turns it into a
dict of numpy arrays (`{f.name: np.asarray(getattr(s, f.name))}`) and hands
that dict here. The JAX state's `rng` key has no counterpart; the caller
makes a `torch.Generator` for the comms-failure draws instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from magics_tpu_torch.graph.state import GbpParams, SimState, require_device

#: fields of magics_tpu's SimState that the port does not carry
DROPPED_FIELDS = frozenset({"rng"})


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy/JAX dtype (or dtype name)."""
    return getattr(torch, np.dtype(dtype).name)


def params_from_jax(params) -> GbpParams:
    """The port's GbpParams with the values of a magics_tpu `GbpParams`."""
    values = {f.name: getattr(params, f.name) for f in dataclasses.fields(GbpParams)}
    values["dtype"] = torch_dtype(params.dtype)
    return GbpParams(**values)


def state_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str = "cuda"
) -> SimState:
    """A SimState on `device` (the card unless the caller asks for the CPU;
    without a card it raises) from a dict of numpy arrays keyed by field name
    (copied, so the port never writes into the caller's buffers). `rng` is
    dropped; any other missing or unknown field raises."""
    device = require_device(device)
    names = {f.name for f in dataclasses.fields(SimState)}
    extra = set(arrays) - names - DROPPED_FIELDS
    missing = names - set(arrays)
    if extra or missing:
        raise ValueError(f"unknown fields {sorted(extra)}, missing {sorted(missing)}")
    return SimState(
        **{n: torch.as_tensor(np.array(arrays[n]), device=device) for n in names}
    )


def state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    """Every field of a SimState as a numpy array on the host."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(SimState)
    }

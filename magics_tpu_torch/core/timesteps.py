"""Variable-timestep spacing along the receding planning horizon (the port's
own copy of magics_tpu/core/timesteps.py).

Behavioural parity with the reference's `get_variable_timesteps`
(crates/magics/src/utils.rs:34-96): variables are placed in groups of
`lookahead_multiple`, the intra-group spacing growing by one per group, so the
spacing increases roughly quadratically while all timesteps stay integral and
the first planned variable is always one timestep after the current state.

E.g. horizon 30, multiple 3 -> [0, 1, 2, 3, 5, 7, 9, 12, 15, 18, 22, 26, 30].

`device_timesteps` holds them as a tensor on a device for the tick
(graph/gbp.py) and the hot layout (kernels/hot.py).
"""

from __future__ import annotations

import functools
import math

import torch


def get_variable_timesteps(lookahead_horizon: int, lookahead_multiple: int) -> list[int]:
    """Timesteps (in units of t0) at which planned variables are placed.

    Matches crates/magics/src/utils.rs:35-75 exactly (same float arithmetic,
    truncating casts and termination rule) so that robot factor graphs have
    the same number of variables and the same dynamic-factor delta-t's.
    """
    if lookahead_horizon <= 0:
        return [0]

    timesteps: list[int] = []
    n = 1 + int(
        0.5 * (-1.0 + math.sqrt(1.0 + 8.0 * float(lookahead_horizon) / float(lookahead_multiple)))
    )
    for i in range(lookahead_multiple * (n + 1)):
        section = i // lookahead_multiple
        # f = (m/2)*section*(section+1) + (i - section*m)*(section+1), computed
        # in f32-ish float; python floats are f64 which only widens the exact
        # integer range, preserving results for realistic horizons.
        f = ((lookahead_multiple / 2.0) * section + (i - section * lookahead_multiple)) * (
            section + 1.0
        )
        if f >= float(lookahead_horizon):
            timesteps.append(lookahead_horizon)
            break
        timesteps.append(int(f))

    return timesteps


# Unbounded: a captured chunk (graph/chunk.py) reads the tensor's address on
# every replay, so an entry must never be evicted and its memory reused.
@functools.cache
def _device_timesteps_cached(ts: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=dtype, device=device)


def device_timesteps(params, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[V] the variables' timesteps (`params.variable_timesteps`) as a
    tensor on `device`, made once per (timesteps, dtype, device) and kept
    for the process's life: a tick copies nothing from the host (a first
    tick, before any capture, makes it)."""
    return _device_timesteps_cached(tuple(params.variable_timesteps), dtype, torch.device(device))

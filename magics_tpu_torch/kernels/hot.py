"""Hot-layout adapter for the slot kernels (counterpart of magics_tpu's
kernels/hot.py, whose GBP loop is graph/gbp.py:iterate_gbp_hot here).

"Hot layout" puts the robot axis last and component axes first, so the slot
kernels (kernels/gbp_slot.py) see every field as a [c..., P, R] plane stack.
The loop transposes the state into this layout once per tick (`to_hot`),
copies the snapshot planes back before each external factor pass
(`_snap_to_state`), sums the inbox into hot planes (`_ext_sum_hot`, one
`ext_sum` launch) and transposes the state back at the end
(`merge_state`). The kernels mask the ragged robot edge themselves, so
nothing is padded.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from magics_tpu_torch.core.timesteps import device_timesteps
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.kernels.ext_sum import ext_sum_hot
from magics_tpu_torch.kernels.gbp_slot import SlotParams, hot, rows


def slot_params(params: GbpParams) -> SlotParams:
    """The slot kernels' static parameters for a scenario."""
    return SlotParams(
        n_vars=params.n_vars,
        max_waypoints=params.max_waypoints,
        sigma_dynamics=params.sigma_factor_dynamics,
        sigma_obstacle=params.sigma_factor_obstacle,
        sigma_tracking=params.sigma_factor_tracking,
        obstacle_delta=F.obstacle_delta(
            params.sdf_shape, (params.world_width, params.world_height)
        ),
        switch_padding=params.tracking_switch_padding,
        attraction_distance=params.tracking_attraction_distance,
        dynamic_enabled=params.dynamic_enabled,
        obstacle_enabled=params.obstacle_enabled,
        tracking_enabled=params.tracking_enabled,
    )


def to_hot(state: SimState, params: GbpParams) -> dict:
    """Transpose the slot-kernel fields into hot layout (contiguous)."""
    f = state.prior_mean.dtype
    ts = device_timesteps(params, f, state.device)
    gaps = ts[1:] - ts[:-1]  # [V-1]
    names = (
        "belief_eta", "belief_lam", "belief_mean", "snap_eta", "snap_lam", "snap_mu",
        "prior_mean", "prior_sigma",
        "dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu", "dyn_f2v_eta", "dyn_f2v_lam",
        "obs_v2f_mu", "obs_f2v_eta", "obs_f2v_lam",
        "trk_v2f_mu", "trk_f2v_eta", "trk_f2v_lam",
        "trk_record", "trk_timeout", "trk_last_pos", "trk_last_val",
    )
    h = {name: hot(getattr(state, name)) for name in names}
    h["delta_t"] = (gaps[:, None] * state.t0[None, :]).contiguous()  # [V1, R]
    h["path_x"] = hot(state.trk_path[..., 0])
    h["path_y"] = hot(state.trk_path[..., 1])
    h["path_len"] = state.trk_path_len[None, :].contiguous()
    return h


def _snap_to_state(state: SimState, h: dict) -> SimState:
    """Copy the hot snapshot planes back into the normal layout — all the
    external factor pass reads from the variables' side."""
    return replace(
        state,
        snap_eta=rows(h["snap_eta"]).contiguous(),
        snap_lam=rows(h["snap_lam"]).contiguous(),
        snap_mu=rows(h["snap_mu"]).contiguous(),
    )


_MERGED = (
    "belief_eta", "belief_lam", "belief_mean", "snap_eta", "snap_lam", "snap_mu",
    "dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu", "dyn_f2v_eta", "dyn_f2v_lam",
    "obs_v2f_mu", "obs_f2v_eta", "obs_f2v_lam",
    "trk_v2f_mu", "trk_f2v_eta", "trk_f2v_lam",
    "trk_record", "trk_timeout", "trk_last_pos", "trk_last_val",
)


def merge_state(state: SimState, h: dict, iter_count: torch.Tensor) -> SimState:
    """Final merge: hot planes -> normal-layout fields."""
    return replace(
        state,
        **{name: rows(h[name]).contiguous() for name in _MERGED},
        iter_count_factor=iter_count,
    )


def _ext_sum_hot(state: SimState) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum the external inboxes (compact rank-1) over slots and lift to hot
    layout over all V variables (external factors touch vars 1..V-1): one
    `ext_sum` launch on the card (kernels/ext_sum.py)."""
    return ext_sum_hot(state.ext_inbox)

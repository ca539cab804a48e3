"""Hot-layout adapter + GBP iteration loop for the slot kernels
(counterpart of magics_tpu's kernels/hot.py).

"Hot layout" puts the robot axis last and component axes first, so the slot
kernels (kernels/gbp_slot.py) see every field as a [c..., P, R] plane stack.
The state is transposed into this layout once per tick; every internal slot
is one `internal_slot` launch (the kernel samples the SDF itself); every
external slot runs the external factor pass on the normal layout (under
"sender" one `interrobot_slot` launch and one row gather), then one
`ext_sum` launch (the inbox summed into hot planes), one `variable_slot`
launch and the response delivery (under "sender" one row gather); the state
is transposed back at the end. The entry sums are one more `ext_sum`.
The kernels mask the ragged robot edge themselves, so nothing is padded.
In a captured graph's stage map (profiling.py) the layout changes are
`gbp.layout`, each run of internal slots `gbp.internal` and each external
slot `gbp.external`.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from magics_tpu_torch import profiling
from magics_tpu_torch.core.constants import TRACKING_SKIP_FIRST_N_FACTOR_ITERS
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.kernels.ext_sum import ext_sum_hot
from magics_tpu_torch.kernels.gbp_slot import (
    SlotParams,
    hot,
    internal_slot,
    rows,
    variable_slot,
)
from magics_tpu_torch.parallel.comm import LOCAL


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
    ts = T._timesteps(params, f, state.device)
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


def iterate_gbp_hot(
    state: SimState, sdf: torch.Tensor, params: GbpParams, *, comm=LOCAL
) -> SimState:
    """`iterate_gbp` on the hot layout with the slot kernels: one
    `internal_slot` launch per internal slot and one `variable_slot` launch
    per external slot; the schedule unrolls in Python."""
    if not params.schedule:
        return state

    f = state.prior_mean.dtype
    sp = slot_params(params)
    world = (params.world_width, params.world_height)

    profiling.stage("gbp.layout")
    h = to_hot(state, params)
    st = state
    ic = state.iter_count_factor
    gate_r = st.active & (st.mission_active | st.completed)  # [R]
    gate_h = gate_r.to(f)[None, :].contiguous()
    ext_sum = _ext_sum_hot(st)

    for i_flag, e_flag in params.schedule:
        if i_flag:
            profiling.stage("gbp.internal")
            tgate_r = gate_r & (ic >= TRACKING_SKIP_FIRST_N_FACTOR_ITERS)
            outs = internal_slot(
                {
                    **h,
                    "gate": gate_h,
                    "tgate": tgate_r.to(f)[None, :].contiguous(),
                    "ext_sum_eta": ext_sum[0],
                    "ext_sum_lam": ext_sum[1],
                },
                sdf,
                world,
                sp,
            )
            h = {**h, **outs}
            ic = ic + gate_r.to(torch.int32)
            # the internal variable pass also seeds the inter-robot cavities
            # (tick.internal_variable_pass)
            if params.interrobot_enabled:
                st = replace(st, ir_int_seeded=T.seed_cavities(st, params, gate_r, comm))
        if e_flag and params.interrobot_enabled:
            # external factor pass on the normal layout (tick.external_factor_pass)
            profiling.stage("gbp.layout")
            st = replace(_snap_to_state(st, h), iter_count_factor=ic)
            profiling.stage("gbp.external")
            st = T.external_factor_pass(st, params, comm)
            ic = st.iter_count_factor

            # external variable pass: the belief update in the kernel
            ext_gate_r = st.active & st.antenna & (st.mission_active | st.completed)
            ext_sum = _ext_sum_hot(st)
            outs = variable_slot(
                {
                    **h,
                    "gate": ext_gate_r.to(f)[None, :].contiguous(),
                    "ext_sum_eta": ext_sum[0],
                    "ext_sum_lam": ext_sum[1],
                },
                sp,
            )
            h = {**h, **outs}
            # response delivery (tick.external_variable_pass): under "sender"
            # a row gather of the peers' new belief positions (K4)
            own_pos = rows(h["belief_mean"])[:, 1:, :2]
            st = replace(
                st,
                ir_v2f_ext_pos=T.deliver_responses(st, params, ext_gate_r, own_pos, comm),
            )

    profiling.stage("gbp.layout")
    return merge_state(st, h, ic)

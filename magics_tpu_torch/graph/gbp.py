"""The GBP iteration schedule and its passes (the GBP part of magics_tpu's
graph/tick.py, and the loop of its kernels/hot.py).

`iterate_gbp` (`iterate_gbp_v2`, robot.rs:1769-1861) runs the schedule
unrolled. It reads `params.uses_kernels` once, and that one read picks the
path and hands it to the exchange (graph/exchange.py):

- the plain loop: the four passes below on the state's own layout, as
  plain operations. It is the reference the kernels' path is tested
  against.
- the kernels' loop, `iterate_gbp_hot`: the state transposed into the hot
  layout once (kernels/hot.py); every internal slot is one `internal_slot`
  launch (K1; the kernel samples the SDF itself); every external slot runs
  the exchange's factor pass on the normal layout, then one `ext_sum`
  launch (the inbox summed into hot planes), one `variable_slot` launch
  (K2) and the response delivery; the state is transposed back at the end.
  The entry sums are one more `ext_sum`.

`scan_schedule` is the JAX package's compile-size knob; the slots run
unrolled whatever it says. `expected_launches` counts the kernel launches
a tick of a schedule makes.

In a captured graph's stage map (profiling.py) each run of internal slots
is `gbp.internal`, each external slot `gbp.external`, and on the kernels'
path the layout changes `gbp.layout`.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from magics_tpu_torch import profiling
from magics_tpu_torch.core.constants import TRACKING_SKIP_FIRST_N_FACTOR_ITERS
from magics_tpu_torch.core.timesteps import device_timesteps
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph import variables as VU
from magics_tpu_torch.graph.exchange import exchange_of
from magics_tpu_torch.graph.masks import not_idle, where_rows
from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.kernels import launch_counts
from magics_tpu_torch.kernels.gbp_slot import internal_slot, rows, variable_slot
from magics_tpu_torch.kernels.hot import (
    _ext_sum_hot, _snap_to_state, merge_state, slot_params, to_hot,
)
from magics_tpu_torch.parallel.comm import LOCAL


# --------------------------------------------------------------------------
# the passes — the plain path, and the in-port reference for the kernels
# --------------------------------------------------------------------------

def _delta_t(state: SimState, params: GbpParams) -> torch.Tensor:
    """[R, V-1] dynamic-factor time gaps t0 * (ts[i+1] - ts[i])."""
    ts = device_timesteps(params, state.t0.dtype, state.device)
    return state.t0[:, None] * (ts[1:] - ts[:-1])[None, :]


def internal_factor_pass(state: SimState, sdf: torch.Tensor, params: GbpParams) -> SimState:
    """All non-interrobot factors update (factorgraph.rs:686-714)."""
    V = state.prior_mean.shape[1]
    f = state.prior_mean.dtype
    gate = state.active & not_idle(state)
    updates: dict = {}

    if params.dynamic_enabled:
        f2v_eta, f2v_lam = F.dynamic_factor_messages(
            state.dyn_v2f_eta, state.dyn_v2f_lam, state.dyn_v2f_mu,
            _delta_t(state, params), params.sigma_factor_dynamics, dtype=f,
        )
        updates["dyn_f2v_eta"] = where_rows(gate, f2v_eta, state.dyn_f2v_eta)
        updates["dyn_f2v_lam"] = where_rows(gate, f2v_lam, state.dyn_f2v_lam)

    world = (params.world_width, params.world_height)
    if params.obstacle_enabled and V > 2:
        h0, hx, hy = F.obstacle_taps(state.obs_v2f_mu, sdf, world, dtype=f)
        o_eta, o_lam = F.obstacle_messages_from_taps(
            h0, hx, hy, state.obs_v2f_mu, F.obstacle_delta(tuple(sdf.shape), world),
            params.sigma_factor_obstacle, dtype=f,
        )
        updates["obs_f2v_eta"] = where_rows(gate, o_eta, state.obs_f2v_eta)
        updates["obs_f2v_lam"] = where_rows(gate, o_lam, state.obs_f2v_lam)

    if params.tracking_enabled and V > 2:
        # factorgraph.rs:701 — skip tracking for the first 10 factor passes
        t_gate = gate & (state.iter_count_factor >= TRACKING_SKIP_FIRST_N_FACTOR_ITERS)
        t_eta, t_lam, new_record, new_timeout, last_pos, last_val, skipped = (
            F.tracking_factor_messages(
                state.trk_v2f_mu, state.trk_path, state.trk_path_len,
                state.trk_record, state.trk_index, state.trk_timeout,
                params.tracking_switch_padding, params.tracking_attraction_distance,
                params.sigma_factor_tracking, dtype=f,
            )
        )
        measured = t_gate[:, None] & ~skipped
        updates["trk_f2v_eta"] = where_rows(t_gate, t_eta, state.trk_f2v_eta)
        updates["trk_f2v_lam"] = where_rows(t_gate, t_lam, state.trk_f2v_lam)
        updates["trk_record"] = where_rows(t_gate, new_record, state.trk_record)
        updates["trk_timeout"] = where_rows(t_gate, new_timeout, state.trk_timeout)
        updates["trk_last_pos"] = torch.where(measured[..., None], last_pos, state.trk_last_pos)
        updates["trk_last_val"] = torch.where(measured, last_val, state.trk_last_val)

    updates["iter_count_factor"] = state.iter_count_factor + gate.to(torch.int32)
    return replace(state, **updates)


def internal_variable_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Belief update + responses to internal factors (factorgraph.rs:762-790)."""
    V = state.prior_mean.shape[1]
    gate = state.active & not_idle(state)

    eta, lam = VU.sum_messages(
        prior_mean=state.prior_mean, prior_sigma=state.prior_sigma,
        dyn_f2v_eta=state.dyn_f2v_eta, dyn_f2v_lam=state.dyn_f2v_lam,
        obs_f2v_eta=state.obs_f2v_eta, obs_f2v_lam=state.obs_f2v_lam,
        trk_f2v_eta=state.trk_f2v_eta, trk_f2v_lam=state.trk_f2v_lam,
        ext_inbox=state.ext_inbox,
    )
    upd = VU.update_beliefs(eta, lam, state.belief_mean)

    belief_eta = where_rows(gate, upd.eta, state.belief_eta)
    belief_lam = where_rows(gate, upd.lam, state.belief_lam)
    belief_mean = where_rows(gate, upd.mean, state.belief_mean)
    updates: dict = {
        "belief_eta": belief_eta,
        "belief_lam": belief_lam,
        "belief_mean": belief_mean,
    }

    if params.dynamic_enabled:
        # dyn edge e: slot 0 <- var e, slot 1 <- var e+1
        v_eta = torch.stack([belief_eta[:, :-1], belief_eta[:, 1:]], dim=2)
        v_lam = torch.stack([belief_lam[:, :-1], belief_lam[:, 1:]], dim=2)
        v_mu = torch.stack([belief_mean[:, :-1], belief_mean[:, 1:]], dim=2)
        updates["dyn_v2f_eta"] = where_rows(gate, v_eta - state.dyn_f2v_eta, state.dyn_v2f_eta)
        updates["dyn_v2f_lam"] = where_rows(gate, v_lam - state.dyn_f2v_lam, state.dyn_v2f_lam)
        updates["dyn_v2f_mu"] = where_rows(gate, v_mu, state.dyn_v2f_mu)

    if V > 2:
        if params.obstacle_enabled:
            updates["obs_v2f_mu"] = where_rows(gate, belief_mean[:, 1 : V - 1], state.obs_v2f_mu)
        if params.tracking_enabled:
            updates["trk_v2f_mu"] = where_rows(gate, belief_mean[:, 1 : V - 1], state.trk_v2f_mu)

    # snapshot for own inter-robot factors (the response to an always-empty
    # inbox entry is the full belief)
    updates["snap_eta"] = where_rows(gate, belief_eta, state.snap_eta)
    updates["snap_lam"] = where_rows(gate, belief_lam, state.snap_lam)
    updates["snap_mu"] = where_rows(gate, belief_mean, state.snap_mu)
    if params.interrobot_enabled:
        updates["ir_int_seeded"] = exchange_of(params).seed_cavities(state, gate, comm)
    return replace(state, **updates)


def external_factor_pass(state: SimState, params: GbpParams, comm=LOCAL,
                         kernels: bool = False) -> SimState:
    """Inter-robot factor update + message delivery (factorgraph.rs:719-760,
    routing robot.rs:1803-1831): the exchange's factor pass, on the
    kernels' path where `kernels`. Messages are compact rank-1."""
    if not params.interrobot_enabled:
        return state
    return exchange_of(params).factor_pass(state, params, comm, kernels)


def external_variable_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Belief update + responses to external factors (factorgraph.rs:794-826,
    routing robot.rs:1843-1858). The factor uses only the response's mean
    position (the exchange's `deliver_responses`)."""
    if not params.interrobot_enabled:
        return state

    gate = state.active & state.antenna & not_idle(state)
    eta, lam = VU.sum_messages(
        prior_mean=state.prior_mean, prior_sigma=state.prior_sigma,
        dyn_f2v_eta=state.dyn_f2v_eta, dyn_f2v_lam=state.dyn_f2v_lam,
        obs_f2v_eta=state.obs_f2v_eta, obs_f2v_lam=state.obs_f2v_lam,
        trk_f2v_eta=state.trk_f2v_eta, trk_f2v_lam=state.trk_f2v_lam,
        ext_inbox=state.ext_inbox,
    )
    upd = VU.update_beliefs(eta, lam, state.belief_mean)
    belief_mean = where_rows(gate, upd.mean, state.belief_mean)
    return replace(
        state,
        belief_eta=where_rows(gate, upd.eta, state.belief_eta),
        belief_lam=where_rows(gate, upd.lam, state.belief_lam),
        belief_mean=belief_mean,
        ir_v2f_ext_pos=exchange_of(params).deliver_responses(
            state, gate, belief_mean[:, 1:, :2], comm),
    )


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

def iterate_gbp(state: SimState, sdf: torch.Tensor, params: GbpParams, comm=LOCAL) -> SimState:
    """`iterate_gbp_v2` (robot.rs:1769-1861): run the iteration schedule,
    unrolled. Where `params.uses_kernels` holds (by default on CUDA) the
    slots run through the kernels (`iterate_gbp_hot`), elsewhere through
    the plain passes."""
    if not params.schedule:
        return state
    if params.uses_kernels(state.device):
        return iterate_gbp_hot(state, sdf, params, comm=comm)

    for internal_flag, external_flag in params.schedule:
        if internal_flag:
            profiling.stage("gbp.internal")
            state = internal_factor_pass(state, sdf, params)
            state = internal_variable_pass(state, params, comm)
        if external_flag:
            profiling.stage("gbp.external")
            state = external_factor_pass(state, params, comm)
            state = external_variable_pass(state, params, comm)
    return state


def iterate_gbp_hot(
    state: SimState, sdf: torch.Tensor, params: GbpParams, *, comm=LOCAL
) -> SimState:
    """`iterate_gbp` on the hot layout with the slot kernels: one
    `internal_slot` launch per internal slot and one `variable_slot` launch
    per external slot, the exchange on its kernels' path; the schedule
    unrolls in Python."""
    f = state.prior_mean.dtype
    sp = slot_params(params)
    world = (params.world_width, params.world_height)
    exchange = exchange_of(params)

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
            # (internal_variable_pass)
            if params.interrobot_enabled:
                st = replace(st, ir_int_seeded=exchange.seed_cavities(st, gate_r, comm))
        if e_flag and params.interrobot_enabled:
            # external factor pass on the normal layout
            profiling.stage("gbp.layout")
            st = replace(_snap_to_state(st, h), iter_count_factor=ic)
            profiling.stage("gbp.external")
            st = external_factor_pass(st, params, comm, kernels=True)
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
            # response delivery (external_variable_pass): under "sender" a
            # row gather of the peers' new belief positions (K4)
            own_pos = rows(h["belief_mean"])[:, 1:, :2]
            st = replace(
                st, ir_v2f_ext_pos=exchange.deliver_responses(st, ext_gate_r, own_pos, comm),
            )

    profiling.stage("gbp.layout")
    return merge_state(st, h, ic)


def expected_launches(params: GbpParams, device: torch.device) -> dict[str, int]:
    """Kernel launches a tick of `params`' schedule on `device`: one K1 per
    internal slot and one K2 per external slot where the slot kernels run,
    and on the slot kernels' path on the card one external sum before the
    schedule and one per external slot; each external slot adds the
    exchange's own launches (graph/exchange.py `launches`)."""
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e) if params.interrobot_enabled else 0
    kernels = params.uses_kernels(device)
    cuda = device.type == "cuda"
    out = dict.fromkeys(launch_counts(), 0)
    out.update(
        internal_slot=n_int if kernels else 0,
        variable_slot=n_ext if kernels else 0,
        ext_sum=(bool(params.schedule) + n_ext) if kernels and cuda else 0,
    )
    for name, n in exchange_of(params).launches(kernels, cuda).items():
        out[name] = n * n_ext
    return out

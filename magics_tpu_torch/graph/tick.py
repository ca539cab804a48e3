"""One simulation FixedUpdate tick (counterpart of magics_tpu's graph/tick.py).

The same system chain (robot.rs:86-108): spawns, reached_waypoint,
connectivity, failed comms, the two prior updates, the GBP iteration
schedule, message counters, collisions, goal areas and the on-device logs.
Everything is dense and masked, as plain functions on tensors; each returns a
new `SimState` and leaves its input untouched (fields it changes are fresh
tensors).

The port carries every configuration the JAX `step` takes on one device:
dense or grid connectivity and collisions (`grid_cell_size > 0`, graph/grid.py),
the collision event records (`collision_log_capacity > 0`), and all three
inter-robot exchanges, branch for branch: "sender" (the reference's routing:
each factor owner computes its outbox, receivers gather it by (peer,
reciprocal slot)), "receiver" and "receiver_compact" (each receiver
recomputes its incoming messages from the peers' gathered snapshot tables
and local mirrors). `scan_schedule` changes only how XLA compiles the
schedule, so the port runs the same slots unrolled whatever it says.

Every cross-robot access goes through `comm` (parallel/comm.py): with a
`ShardComm` the same step runs on one rank's rows of a robot-sharded state,
its gathers and sums collectives (parallel/shard_tick.py), except the
collision event rings, whose write order is global.

A tick copies nothing from the host to the card and never waits for the
card, so a chunk of ticks can be captured in a CUDA graph (graph/chunk.py):
its constants are device tensors cached per device (`_timesteps`) or Python
scalars handed to the ops.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import torch

from magics_tpu_torch.core.constants import TRACKING_SKIP_FIRST_N_FACTOR_ITERS
from magics_tpu_torch.core.linalg import inv4_rowscaled
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph import grid as G
from magics_tpu_torch.graph import variables as VU
from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.kernels import ir_slot as IR
from magics_tpu_torch.kernels.layout import gather_rows
from magics_tpu_torch.parallel.comm import LOCAL


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _exp(mask: torch.Tensor, ndim_extra: int) -> torch.Tensor:
    """Expand a boolean mask with trailing singleton dims."""
    return mask.reshape(mask.shape + (1,) * ndim_extra)


def _where_rows(gate_r: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-robot select between two [R, ...] tensors."""
    return torch.where(_exp(gate_r, new.ndim - 1), new, old)


def _set_where(arr: torch.Tensor, index, gate: torch.Tensor, value) -> torch.Tensor:
    """A copy of `arr` with `arr[index]` replaced by `value` (a tensor, or a
    Python scalar handed to the op as it is) where the per-robot `gate`
    holds (the JAX `.at[index].set(where(gate, value, old))`)."""
    out = arr.clone()
    old = arr[index]
    if isinstance(value, torch.Tensor):
        value = value.to(arr.dtype)
    out[index] = torch.where(_exp(gate, old.ndim - gate.ndim), value, old)
    return out


# Unbounded: a captured chunk (graph/chunk.py) reads the tensor's address on
# every replay, so an entry must never be evicted and its memory reused.
@functools.cache
def _timesteps_cached(ts: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=dtype, device=device)


def _timesteps(params: GbpParams, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[V] the variables' timesteps as a tensor on `device`, made once per
    (timesteps, dtype, device) and kept for the process's life: a tick
    copies nothing from the host (a first tick, before any capture, makes
    it)."""
    return _timesteps_cached(tuple(params.variable_timesteps), dtype, torch.device(device))


def _clip_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.clamp(0, n - 1).long()


def compute_back_slots(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor, comm=LOCAL):
    """back[r, k] = slot k' on robot j = nbr_idx[r,k] with nbr_idx[j,k'] == r
    (the first such slot: `argmax` returns the first maximum, like
    `jnp.argmax`); has_back where such a slot exists and the slot is live."""
    Rl, K = nbr_idx.shape
    nbr_all = comm.all_robots(nbr_idx)
    their_rows = nbr_all[_clip_idx(nbr_idx, nbr_all.shape[0])]   # [Rl, K, K]
    me = comm.row_ids(Rl, nbr_idx.device).to(nbr_idx.dtype)[:, None, None]
    eq = their_rows == me
    back = eq.to(torch.uint8).argmax(dim=-1).to(torch.int32)
    has_back = eq.any(dim=-1) & nbr_mask
    return back, has_back


def _gather_from_peer(arr: torch.Tensor, nbr_idx, back, mask) -> torch.Tensor:
    """out[r, k, ...] = arr[nbr_idx[r,k], back[r,k], ...], 0 where ~mask.
    `arr` must be a GLOBAL [R_total, K, ...] tensor (comm.all_robots'd).
    One row gather (K4, kernels/layout.py) of the flattened [R*K, ...]
    table, where the JAX package pins XLA's layout around the same gather."""
    R, K = arr.shape[:2]
    idx = _clip_idx(nbr_idx, R) * K + _clip_idx(back, K)
    return _gather_rows_pinned(arr.reshape(R * K, *arr.shape[2:]), idx, mask)


def _gather_robot(arr: torch.Tensor, nbr_idx, mask) -> torch.Tensor:
    """out[r, k, ...] = arr[nbr_idx[r,k], ...], 0 where ~mask.
    `arr` must be a GLOBAL [R_total, ...] tensor (comm.all_robots'd). Plain
    indexing: the JAX package pins no layout around the gathers of
    connectivity and the horizon; the exchanges' gathers go through
    `_gather_rows_pinned`."""
    out = arr[_clip_idx(nbr_idx, arr.shape[0])]
    return torch.where(_exp(mask, out.ndim - 2), out, torch.zeros_like(out))


def _gather_rows_pinned(arr: torch.Tensor, idx: torch.Tensor, mask=None) -> torch.Tensor:
    """out[r, k, ...] = arr[idx[r, k], ...], 0 where `mask` [r, k] is false:
    one row gather (K4, kernels/layout.py) of `arr` flattened to rows, at
    each site where the JAX package pins XLA's layout around the gather.
    `idx` is clipped by the caller."""
    out = gather_rows(
        arr.reshape(arr.shape[0], -1).contiguous(), idx.reshape(-1).long(),
        None if mask is None else mask.reshape(-1),
    )
    return out.reshape(idx.shape + arr.shape[1:])


# --------------------------------------------------------------------------
# spawn / waypoints / comms
# --------------------------------------------------------------------------

def activate_due_spawns(state: SimState) -> SimState:
    """Activate robots whose spawn tick has arrived; robots awaiting an
    in-flight plan spawn Idle (active but not mission-active)."""
    due = (
        ~state.active
        & ~state.completed
        & (state.spawn_tick >= 0)
        & (state.spawn_tick <= state.tick)
    )
    return replace(
        state,
        active=state.active | due,
        mission_active=state.mission_active | (due & ~state.plan_pending),
    )


def check_waypoints(state: SimState, params: GbpParams) -> SimState:
    """`reached_waypoint` (robot.rs:2080-2176) + despawn-on-finish."""
    R, V = state.prior_mean.shape[:2]
    rows = torch.arange(R, device=state.device)
    gate = state.active & state.mission_active & ~state.completed
    gate = gate & (state.target_idx < state.n_waypoints)

    is_last = state.target_idx == state.n_waypoints - 1
    check_var = torch.where(is_last, state.fin_check_var, state.wp_check_var)
    check_d2 = torch.where(is_last, state.fin_check_dist2, state.wp_check_dist2)

    est = state.belief_mean[rows, _clip_idx(check_var, V), :2]          # [R, 2]
    wp = state.waypoints[rows, _clip_idx(state.target_idx, state.waypoints.shape[1]), :2]

    d2 = ((est - wp) ** 2).sum(dim=-1)
    reached = gate & (d2 < check_d2)

    new_target = torch.where(reached, state.target_idx + 1, state.target_idx)
    newly_completed = reached & (new_target >= state.n_waypoints)
    completed = state.completed | newly_completed

    elapsed = state.tick.to(state.finished_at.dtype) / params.hz
    finished_at = torch.where(newly_completed, elapsed, state.finished_at)
    trk_index = torch.where(reached & ~newly_completed, new_target, state.trk_index)

    active = state.active
    if params.despawn_on_final_waypoint:
        active = active & ~newly_completed

    return replace(
        state,
        target_idx=new_target,
        completed=completed,
        finished_at=finished_at,
        trk_index=trk_index,
        active=active,
        mission_active=state.mission_active & ~newly_completed,
    )


def update_failed_comms(
    state: SimState, params: GbpParams, comm=LOCAL,
    generator: torch.Generator | None = None,
) -> SimState:
    """Bernoulli antenna failure per robot per tick (robot.rs:1593-1601).

    The draws come from `generator` (on the state's device), not from the
    JAX PRNG: the two give different bits from the same seed, so failure
    sweeps compare by distribution only (ROADMAP fault F3)."""
    if params.comms_failure_rate <= 0.0:
        return replace(state, antenna=torch.ones_like(state.antenna))
    if generator is None:
        raise ValueError("comms_failure_rate > 0 needs a torch.Generator")
    Rl = state.antenna.shape[0]
    R = Rl * getattr(comm, "n_shards", 1)
    off = torch.rand(R, generator=generator, device=state.device) < params.comms_failure_rate
    return replace(state, antenna=~comm.take_rows(off, Rl))


# --------------------------------------------------------------------------
# connectivity (delete/create inter-robot factors)
# --------------------------------------------------------------------------

def update_connectivity(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Neighbour discovery + inter-robot factor lifecycle, dense O(R^2)
    (magics_tpu tick.py:update_connectivity).

    New neighbours fill free slots nearest-first, ties by ascending id. The
    JAX package gets that order from `lax.top_k`, which is stable;
    `torch.topk` on CUDA is not, so the port takes the first K columns of a
    stable ascending sort of the distance keys (ROADMAP fault F2).
    """
    Rl, K = state.nbr_idx.shape
    dev = state.device
    pos_all = comm.all_robots(state.pos)
    act_all = comm.all_robots(state.active)
    R = act_all.shape[0]
    me = comm.row_ids(Rl, dev)

    diff = state.pos[:, None, :] - pos_all[None, :, :]
    d2 = (diff * diff).sum(dim=-1)                        # [Rl, R]
    radius2 = params.comms_radius * params.comms_radius
    cols = torch.arange(R, dtype=torch.int32, device=dev)
    not_self = cols[None, :] != me[:, None]
    in_range = (d2 <= radius2) & not_self & state.active[:, None] & act_all[None, :]

    rows = torch.arange(Rl, device=dev)[:, None]
    keep = state.nbr_mask & in_range[rows, _clip_idx(state.nbr_idx, R)]

    kept_ids = torch.where(keep, state.nbr_idx, torch.full_like(state.nbr_idx, -1))
    conn = (kept_ids[:, :, None] == cols[None, None, :]).any(dim=1)   # [Rl, R]
    new_pair = in_range & ~conn

    key = torch.where(new_pair, d2, torch.full_like(d2, float("inf")))
    kk = min(K, R)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    cand_id = order[:, :kk]
    cand_ok = sorted_key[:, :kk] < float("inf")
    free_rank = torch.cumsum((~keep).to(torch.int32), dim=1) - 1      # [Rl, K]
    fr = free_rank.clamp(0, kk - 1).long()
    new_id = torch.gather(cand_id, 1, fr).to(torch.int32)
    new_ok = torch.gather(cand_ok, 1, fr)
    take = ~keep & (free_rank >= 0) & (free_rank < kk) & new_ok
    nbr_idx_new = torch.where(take, new_id, torch.full_like(new_id, -1))
    nbr_idx_new = torch.where(keep, state.nbr_idx, nbr_idx_new)

    n_new = new_pair.sum(dim=1)
    n_free = (~keep).sum(dim=1)
    dropped = comm.psum(torch.clamp(n_new - n_free, min=0).sum())
    return _finish_connectivity(state, params, keep, nbr_idx_new, comm, dropped)


def _finish_connectivity(
    state: SimState, params: GbpParams, keep: torch.Tensor, nbr_idx_new: torch.Tensor,
    comm, dropped: torch.Tensor,
) -> SimState:
    """Shared connectivity tail: reciprocity, message-state reset for churned
    slots, new-factor seeding, and the reciprocal-slot cache."""
    is_new = ~keep & (nbr_idx_new >= 0)
    mask_new = keep | is_new

    back, has_back = compute_back_slots(nbr_idx_new, mask_new, comm)
    mask_new = mask_new & has_back
    is_new = is_new & mask_new

    slot_reset = ~keep

    def reset(arr):
        return torch.where(_exp(slot_reset, arr.ndim - 2), torch.zeros_like(arr), arr)

    ir_v2f_ext_pos = reset(state.ir_v2f_ext_pos)
    seeded = torch.where(slot_reset[..., None], False, state.ir_int_seeded)

    # seed new factors' external linearisation point with the neighbour's
    # current belief position (robot.rs:1556-1566); variables 1..V-1 map to
    # chain slots 0..V-2
    if params.ext_exchange != "sender":
        # receiver-computes mirror: the PEER's new factor was seeded with MY
        # current belief position, so the mirror write is local
        ext_pos = state.belief_mean[:, None, 1:, :2]
    else:
        ext_pos = _gather_robot(
            comm.all_robots(state.belief_mean[..., :2]), nbr_idx_new, is_new
        )[:, :, 1:, :]
    ir_v2f_ext_pos = torch.where(_exp(is_new, 2), ext_pos, ir_v2f_ext_pos)

    K = nbr_idx_new.shape[1]
    mask_all = comm.all_robots(mask_new)
    j_safe = _clip_idx(nbr_idx_new, mask_all.shape[0])
    peer_alive = mask_all.reshape(-1)[j_safe * K + _clip_idx(back, K)]
    has_back_final = mask_new & peer_alive

    return replace(
        state,
        nbr_idx=torch.where(mask_new, nbr_idx_new, torch.full_like(nbr_idx_new, -1)),
        nbr_mask=mask_new,
        nbr_back=back,
        nbr_has_back=has_back_final,
        ir_int_seeded=seeded,
        ir_v2f_ext_pos=ir_v2f_ext_pos,
        ir_f2v_ext=reset(state.ir_f2v_ext),
        ext_inbox=reset(state.ext_inbox),
        nbr_overflow=state.nbr_overflow + dropped.to(torch.int32),
    )


def _grid_spec(params: GbpParams) -> G.GridSpec:
    """The grid of the tick: its stencil covers the comms radius and every
    possible colliding pair (d < r_i + r_j <= 2 max_robot_radius), so one
    candidate table serves connectivity and collisions."""
    return G.make_grid_spec(
        (params.world_width, params.world_height),
        params.grid_cell_size,
        max(params.comms_radius, 2.0 * params.max_robot_radius),
        params.grid_capacity,
    )


def grid_candidates(state: SimState, params: GbpParams, comm=LOCAL):
    """Each local robot's stencil candidates with their data (magics_tpu
    tick.py:grid_candidates): (cand_idx [Rl, M], cand_pos [Rl, M, 2],
    cand_rad [Rl, M], cand_mask [Rl, M]). The bucket tables are built from
    the gathered global positions; lookups run on the local rows."""
    Rl = state.pos.shape[0]
    spec = _grid_spec(params)
    bucket, bpos, brad = G.build_grid_tables(
        spec, comm.all_robots(state.pos), comm.all_robots(state.active),
        comm.all_robots(state.radius),
    )
    cell_l = G.cell_ids(spec, state.pos, state.active)
    return G.candidate_data(
        spec, cell_l, bucket, bpos, brad, state.active,
        row_ids=comm.row_ids(Rl, state.device),
    )


def update_connectivity_grid(
    state: SimState, params: GbpParams, comm=LOCAL, candidates=None
) -> SimState:
    """Grid connectivity (magics_tpu tick.py:update_connectivity_grid): the
    semantics of `update_connectivity`, the pair search over the stencil
    candidates. Nothing here is [R, R].

    The JAX package takes the K nearest new pairs by `lax.top_k`, whose
    ties keep the lower column (it is stable), then re-sorts them by (d2,
    id) so that both paths fill slots alike. `torch.topk` is not stable
    (ROADMAP fault F2): the port takes the first K columns of a stable
    sort, and the (d2, id) order from two stable sorts, by id, then by d2."""
    Rl, K = state.nbr_idx.shape
    pos_all = comm.all_robots(state.pos)
    act_all = comm.all_robots(state.active)
    R = act_all.shape[0]
    cand_idx, cand_pos, _, cand_mask = (
        candidates if candidates is not None else grid_candidates(state, params, comm)
    )
    # bucket-capacity drops, counted in-state once a tick
    state = replace(
        state,
        grid_overflow=state.grid_overflow
        + G.grid_overflow(_grid_spec(params), pos_all, act_all).to(torch.int32),
    )
    radius2 = params.comms_radius * params.comms_radius

    # keep existing slots by exact distance (both endpoints alive)
    safe = _clip_idx(state.nbr_idx, R)
    diff = state.pos[:, None, :] - pos_all[safe]
    d2_slot = (diff * diff).sum(dim=-1)
    keep = state.nbr_mask & state.active[:, None] & act_all[safe] & (d2_slot <= radius2)

    # in-range candidates not already connected (cand_pos is far away where
    # masked, so the distance test gates too)
    diff = state.pos[:, None, :] - cand_pos
    d2 = (diff * diff).sum(dim=-1)                        # [Rl, M]
    in_range = cand_mask & (d2 <= radius2)
    kept_ids = torch.where(keep, state.nbr_idx, torch.full_like(state.nbr_idx, -2))
    connected = (cand_idx[:, :, None] == kept_ids[:, None, :]).any(dim=-1)
    new_pair = in_range & ~connected

    key = torch.where(new_pair, d2, torch.full_like(d2, float("inf")))
    M = key.shape[1]
    kk = min(K, M)
    sel_d2, sel = torch.sort(key, dim=1, stable=True)
    sel_d2, sel = sel_d2[:, :kk], sel[:, :kk]
    sel_ids = torch.gather(cand_idx, 1, sel)
    # (d2, id) lexicographic: by id, then stably by d2
    by_id = torch.sort(sel_ids, dim=1, stable=True)
    sel_ids = by_id.values
    sel_d2 = torch.gather(sel_d2, 1, by_id.indices)
    sel_d2, by_d2 = torch.sort(sel_d2, dim=1, stable=True)
    sel_ids = torch.gather(sel_ids, 1, by_d2)
    sel_ok = sel_d2 < float("inf")
    free_rank = torch.cumsum((~keep).to(torch.int32), dim=1) - 1      # [Rl, K]
    fr = free_rank.clamp(0, kk - 1).long()
    new_id = torch.gather(sel_ids, 1, fr).to(torch.int32)
    new_ok = torch.gather(sel_ok, 1, fr)
    valid = ~keep & (free_rank >= 0) & (free_rank < M) & new_ok
    nbr_idx_new = torch.where(valid, new_id, torch.full_like(new_id, -1))
    nbr_idx_new = torch.where(keep, state.nbr_idx, nbr_idx_new)

    n_new = new_pair.sum(dim=1)
    n_free = (~keep).sum(dim=1)
    dropped = comm.psum(torch.clamp(n_new - n_free, min=0).sum())
    return _finish_connectivity(state, params, keep, nbr_idx_new, comm, dropped)


# --------------------------------------------------------------------------
# prior updates
# --------------------------------------------------------------------------

def update_prior_horizon(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """`update_prior_of_horizon_state` (robot.rs:2182-2283): the horizon
    variable's prior is pulled towards the next waypoint at (at most) target
    speed; its belief mean jumps there, its full belief goes to its factors
    and its own inbox is emptied. No-op with a zero-internal schedule."""
    if not any(i for i, _ in params.schedule):
        return state

    R, V = state.prior_mean.shape[:2]
    f = state.prior_mean.dtype
    rows = torch.arange(R, device=state.device)
    gate = (
        state.active
        & state.mission_active
        & ~state.completed
        & (state.target_idx < state.n_waypoints)
    )

    est_pos = state.belief_mean[:, V - 1, :2]
    wp = state.waypoints[rows, _clip_idx(state.target_idx, state.waypoints.shape[1]), :2]
    h2w = wp - est_pos
    dist = torch.linalg.vector_norm(h2w, dim=-1, keepdim=True)
    direction = torch.where(
        dist > 0, h2w / torch.where(dist > 0, dist, torch.ones_like(dist)),
        torch.zeros_like(h2w),
    )
    new_vel = torch.clamp(dist, max=params.target_speed) * direction
    new_pos = est_pos + new_vel * params.dt
    new_mean = torch.cat([new_pos, new_vel], dim=-1).to(f)  # [R, 4]

    h_eta = state.belief_eta[:, V - 1]
    h_lam = state.belief_lam[:, V - 1]
    hor, last_edge = (slice(None), V - 1), (slice(None), V - 2, 1)

    gate_all = comm.all_robots(gate)
    src = _clip_idx(state.nbr_idx, gate_all.shape[0])
    seeded = state.ir_int_seeded.clone()
    ir_v2f_ext_pos = state.ir_v2f_ext_pos.clone()
    if params.ext_exchange != "sender":
        # receiver-computes mirrors (magics_tpu state.py): the PEER's factor
        # received MY new horizon mean, and the PEER's seeded flag for its
        # slot V-2 went true where ITS gate held
        seeded[:, :, V - 2] |= gate_all[src] & state.nbr_has_back
        ir_v2f_ext_pos[:, :, V - 2] = torch.where(
            (gate[:, None] & state.nbr_has_back)[..., None],
            new_mean[:, None, :2],
            state.ir_v2f_ext_pos[:, :, V - 2],
        )
    else:
        seeded[:, :, V - 2] = torch.where(
            gate[:, None], state.nbr_mask, state.ir_int_seeded[:, :, V - 2]
        )
        # responses to external factors (ungated receive, robot.rs:2272-2282):
        # the factor owned by (r, k) at chain slot V-2 has j = nbr_idx[r, k]'s
        # horizon variable as its external variable
        sent = gate_all[src] & state.nbr_mask
        ir_v2f_ext_pos[:, :, V - 2] = torch.where(
            sent[..., None], comm.all_robots(new_mean)[src][..., :2],
            state.ir_v2f_ext_pos[:, :, V - 2],
        )

    return replace(
        state,
        prior_mean=_set_where(state.prior_mean, hor, gate, new_mean),
        belief_mean=_set_where(state.belief_mean, hor, gate, new_mean),
        dyn_v2f_eta=_set_where(state.dyn_v2f_eta, last_edge, gate, h_eta),
        dyn_v2f_lam=_set_where(state.dyn_v2f_lam, last_edge, gate, h_lam),
        dyn_v2f_mu=_set_where(state.dyn_v2f_mu, last_edge, gate, new_mean),
        snap_eta=_set_where(state.snap_eta, hor, gate, h_eta),
        snap_lam=_set_where(state.snap_lam, hor, gate, h_lam),
        snap_mu=_set_where(state.snap_mu, hor, gate, new_mean),
        ir_int_seeded=seeded,
        ir_v2f_ext_pos=ir_v2f_ext_pos,
        # empty the horizon variable's inbox
        dyn_f2v_eta=_set_where(state.dyn_f2v_eta, last_edge, gate, 0.0),
        dyn_f2v_lam=_set_where(state.dyn_f2v_lam, last_edge, gate, 0.0),
        ext_inbox=_set_where(state.ext_inbox, (slice(None), slice(None), V - 2), gate, 0.0),
    )


def update_prior_current(state: SimState, params: GbpParams) -> SimState:
    """`update_prior_of_current_state_v3` (robot.rs:2286-2338): the current
    variable's mean advances towards variable 1 by dt / t0 and the robot's
    position moves by the same amount."""
    gate = state.active & (state.mission_active | state.completed)

    time_scale = (params.dt / state.t0)[:, None]
    change = time_scale * (state.belief_mean[:, 1] - state.belief_mean[:, 0])
    new_mean = state.belief_mean[:, 0] + change

    c_eta = state.belief_eta[:, 0]
    c_lam = state.belief_lam[:, 0]
    cur, first_edge = (slice(None), 0), (slice(None), 0, 0)

    return replace(
        state,
        prior_mean=_set_where(state.prior_mean, cur, gate, new_mean),
        belief_mean=_set_where(state.belief_mean, cur, gate, new_mean),
        dyn_v2f_eta=_set_where(state.dyn_v2f_eta, first_edge, gate, c_eta),
        dyn_v2f_lam=_set_where(state.dyn_v2f_lam, first_edge, gate, c_lam),
        dyn_v2f_mu=_set_where(state.dyn_v2f_mu, first_edge, gate, new_mean),
        snap_eta=_set_where(state.snap_eta, cur, gate, c_eta),
        snap_lam=_set_where(state.snap_lam, cur, gate, c_lam),
        snap_mu=_set_where(state.snap_mu, cur, gate, new_mean),
        dyn_f2v_eta=_set_where(state.dyn_f2v_eta, first_edge, gate, 0.0),
        dyn_f2v_lam=_set_where(state.dyn_f2v_lam, first_edge, gate, 0.0),
        pos=_where_rows(gate, state.pos + change[:, :2], state.pos),
    )


# --------------------------------------------------------------------------
# GBP passes — the plain path, and the in-port reference for the kernels
# --------------------------------------------------------------------------

def _not_idle(state: SimState) -> torch.Tensor:
    return state.mission_active | state.completed


def _delta_t(state: SimState, params: GbpParams) -> torch.Tensor:
    """[R, V-1] dynamic-factor time gaps t0 * (ts[i+1] - ts[i])."""
    ts = _timesteps(params, state.t0.dtype, state.device)
    return state.t0[:, None] * (ts[1:] - ts[:-1])[None, :]


def internal_factor_pass(state: SimState, sdf: torch.Tensor, params: GbpParams) -> SimState:
    """All non-interrobot factors update (factorgraph.rs:686-714)."""
    V = state.prior_mean.shape[1]
    f = state.prior_mean.dtype
    gate = state.active & _not_idle(state)
    updates: dict = {}

    if params.dynamic_enabled:
        f2v_eta, f2v_lam = F.dynamic_factor_messages(
            state.dyn_v2f_eta, state.dyn_v2f_lam, state.dyn_v2f_mu,
            _delta_t(state, params), params.sigma_factor_dynamics, dtype=f,
        )
        updates["dyn_f2v_eta"] = _where_rows(gate, f2v_eta, state.dyn_f2v_eta)
        updates["dyn_f2v_lam"] = _where_rows(gate, f2v_lam, state.dyn_f2v_lam)

    world = (params.world_width, params.world_height)
    if params.obstacle_enabled and V > 2:
        h0, hx, hy = F.obstacle_taps(state.obs_v2f_mu, sdf, world, dtype=f)
        o_eta, o_lam = F.obstacle_messages_from_taps(
            h0, hx, hy, state.obs_v2f_mu, F.obstacle_delta(tuple(sdf.shape), world),
            params.sigma_factor_obstacle, dtype=f,
        )
        updates["obs_f2v_eta"] = _where_rows(gate, o_eta, state.obs_f2v_eta)
        updates["obs_f2v_lam"] = _where_rows(gate, o_lam, state.obs_f2v_lam)

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
        updates["trk_f2v_eta"] = _where_rows(t_gate, t_eta, state.trk_f2v_eta)
        updates["trk_f2v_lam"] = _where_rows(t_gate, t_lam, state.trk_f2v_lam)
        updates["trk_record"] = _where_rows(t_gate, new_record, state.trk_record)
        updates["trk_timeout"] = _where_rows(t_gate, new_timeout, state.trk_timeout)
        updates["trk_last_pos"] = torch.where(measured[..., None], last_pos, state.trk_last_pos)
        updates["trk_last_val"] = torch.where(measured, last_val, state.trk_last_val)

    updates["iter_count_factor"] = state.iter_count_factor + gate.to(torch.int32)
    return replace(state, **updates)


def seed_cavities(state: SimState, params: GbpParams, gate: torch.Tensor, comm=LOCAL) -> torch.Tensor:
    """`ir_int_seeded` after an internal variable pass under `gate`. Under
    "sender" a robot's own cavities of its live slots go live where its gate
    held; under the receiver exchanges the flag mirrors the PEER's: the
    peer's cavity for its reciprocal slot went live where ITS gate held."""
    if params.ext_exchange == "sender":
        return state.ir_int_seeded | (gate[:, None] & state.nbr_mask)[..., None]
    gate_all = comm.all_robots(gate)
    src = _clip_idx(state.nbr_idx, gate_all.shape[0])
    return state.ir_int_seeded | (gate_all[src] & state.nbr_has_back)[..., None]


def internal_variable_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Belief update + responses to internal factors (factorgraph.rs:762-790)."""
    V = state.prior_mean.shape[1]
    gate = state.active & _not_idle(state)

    eta, lam = VU.sum_messages(
        prior_mean=state.prior_mean, prior_sigma=state.prior_sigma,
        dyn_f2v_eta=state.dyn_f2v_eta, dyn_f2v_lam=state.dyn_f2v_lam,
        obs_f2v_eta=state.obs_f2v_eta, obs_f2v_lam=state.obs_f2v_lam,
        trk_f2v_eta=state.trk_f2v_eta, trk_f2v_lam=state.trk_f2v_lam,
        ext_inbox=state.ext_inbox,
    )
    upd = VU.update_beliefs(eta, lam, state.belief_mean)

    belief_eta = _where_rows(gate, upd.eta, state.belief_eta)
    belief_lam = _where_rows(gate, upd.lam, state.belief_lam)
    belief_mean = _where_rows(gate, upd.mean, state.belief_mean)
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
        updates["dyn_v2f_eta"] = _where_rows(gate, v_eta - state.dyn_f2v_eta, state.dyn_v2f_eta)
        updates["dyn_v2f_lam"] = _where_rows(gate, v_lam - state.dyn_f2v_lam, state.dyn_v2f_lam)
        updates["dyn_v2f_mu"] = _where_rows(gate, v_mu, state.dyn_v2f_mu)

    if V > 2:
        if params.obstacle_enabled:
            updates["obs_v2f_mu"] = _where_rows(gate, belief_mean[:, 1 : V - 1], state.obs_v2f_mu)
        if params.tracking_enabled:
            updates["trk_v2f_mu"] = _where_rows(gate, belief_mean[:, 1 : V - 1], state.trk_v2f_mu)

    # snapshot for own inter-robot factors (the response to an always-empty
    # inbox entry is the full belief)
    updates["snap_eta"] = _where_rows(gate, belief_eta, state.snap_eta)
    updates["snap_lam"] = _where_rows(gate, belief_lam, state.snap_lam)
    updates["snap_mu"] = _where_rows(gate, belief_mean, state.snap_mu)
    if params.interrobot_enabled:
        updates["ir_int_seeded"] = seed_cavities(state, params, gate, comm)
    return replace(state, **updates)


def _external_factor_pass_receiver(
    state: SimState, params: GbpParams, comm=LOCAL
) -> SimState:
    """Receiver-computes inter-robot exchange (magics_tpu
    tick.py:_external_factor_pass_receiver): each receiver recomputes its
    incoming messages from a row gather of the peers' snapshot tables, the
    mirror of its own positions as held by the peer, and slot-deterministic
    tiny offsets. "receiver" gathers the [R, V-1, 24] snapshot pack and runs
    the sender's rank-1 maths on it (the same arithmetic, so the same
    inboxes); "receiver_compact" gathers the compact cavity tables
    [R, V-1, 8] (Sherman-Morrison, equal to roundoff)."""
    R, K = state.nbr_idx.shape
    V1 = state.prior_mean.shape[1] - 1
    f = state.prior_mean.dtype
    dev = state.device

    send_gate = state.active & state.antenna & _not_idle(state)
    gate_all = comm.all_robots(send_gate)
    src = _clip_idx(state.nbr_idx, gate_all.shape[0])
    deliver = send_gate[:, None] & state.nbr_mask & gate_all[src] & state.nbr_has_back

    gids_j = src.to(f)
    back = state.nbr_back.to(f)
    iota_v = torch.arange(V1, dtype=f, device=dev)
    tiny = 1e-6 * (gids_j[..., None] * (K * V1) + back[..., None] * V1 + iota_v + 1.0)

    rad_all = comm.all_robots(state.radius)
    safety = (params.safety_distance_multiplier * rad_all[src])[..., None].expand(R, K, V1)

    seeded = state.ir_int_seeded      # mirror: the peer's cavity is present
    p_ext = state.ir_v2f_ext_pos      # mirror: my position as held by the peer
    if params.ext_exchange == "receiver_compact":
        tables = F.compact_snap_tables(state.snap_mu, state.snap_eta, state.snap_lam, dtype=f)
        tables_all = comm.all_robots(tables).reshape(-1, V1 * 8)
        peer_tab = _gather_rows_pinned(tables_all, src).reshape(R, K, V1, 8)
        msg = F.interrobot_rank1_messages_compact(
            peer_tab, seeded, p_ext, safety, tiny, params.sigma_factor_interrobot, dtype=f,
        )
    else:
        pack = torch.cat(
            [state.snap_mu[:, 1:], state.snap_eta[:, 1:], state.snap_lam[:, 1:].reshape(R, V1, 16)],
            dim=-1,
        )  # [R, V1, 24]
        pack_all = comm.all_robots(pack).reshape(-1, V1 * 24)
        peer = _gather_rows_pinned(pack_all, src).reshape(R, K, V1, 24)
        s3 = seeded[..., None]
        x_int = torch.where(s3, peer[..., 0:4], 0.0)
        cav_eta = torch.where(s3, peer[..., 4:8], 0.0)
        cav_lam = torch.where(s3[..., None], peer[..., 8:24].reshape(R, K, V1, 4, 4), 0.0)
        msg = F.interrobot_rank1_messages(
            x_int, p_ext, cav_eta, cav_lam, safety, tiny, params.sigma_factor_interrobot, dtype=f,
        )
    return replace(
        state,
        ext_inbox=torch.where(deliver[..., None, None], msg, state.ext_inbox),
        iter_count_factor=state.iter_count_factor + send_gate.to(torch.int32),
    )


def external_factor_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Inter-robot factor update + message delivery (factorgraph.rs:719-760,
    routing robot.rs:1803-1831). Messages are compact rank-1.

    "sender": each robot computes the outbox `ir_f2v_ext` of its own
    factors (in the kernel of kernels/ir_slot.py where
    `params.uses_kernels` holds: by default on CUDA), and
    each receiver gathers its inbox from the peers' outboxes by (peer,
    reciprocal slot). The receiver exchanges recompute instead
    (`_external_factor_pass_receiver`)."""
    if not params.interrobot_enabled:
        return state
    if params.ext_exchange != "sender":
        return _external_factor_pass_receiver(state, params, comm)

    send_gate = state.active & state.antenna & _not_idle(state)  # [R]
    inputs = IR.sender_inputs(state, params, comm)
    sigma = params.sigma_factor_interrobot
    if params.uses_kernels(state.device):
        msg = IR.interrobot_slot(**inputs, sigma=sigma)
    else:
        msg = IR.interrobot_slot_reference(**inputs, sigma=sigma)  # [R, K, V-1, 4]

    produced = send_gate[:, None] & state.nbr_mask
    ir_f2v_ext = torch.where(produced[..., None, None], msg, state.ir_f2v_ext)

    # delivery: r's inbox slot (r, k, i) receives from the factor owned by
    # j = nbr_idx[r, k] at its reciprocal slot, where j produced this pass
    # and r's antenna and mission gate hold
    send_gate_all = comm.all_robots(send_gate)
    src = _clip_idx(state.nbr_idx, send_gate_all.shape[0])
    deliver = send_gate[:, None] & state.nbr_mask & send_gate_all[src] & state.nbr_has_back
    in_msg = _gather_from_peer(
        comm.all_robots(ir_f2v_ext), state.nbr_idx, state.nbr_back, state.nbr_mask
    )
    return replace(
        state,
        ir_f2v_ext=ir_f2v_ext,
        ext_inbox=torch.where(deliver[..., None, None], in_msg, state.ext_inbox),
        iter_count_factor=state.iter_count_factor + send_gate.to(torch.int32),
    )


def external_variable_pass(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Belief update + responses to external factors (factorgraph.rs:794-826,
    routing robot.rs:1843-1858). The factor uses only the response's mean
    position (`deliver_responses`)."""
    if not params.interrobot_enabled:
        return state

    gate = state.active & state.antenna & _not_idle(state)
    eta, lam = VU.sum_messages(
        prior_mean=state.prior_mean, prior_sigma=state.prior_sigma,
        dyn_f2v_eta=state.dyn_f2v_eta, dyn_f2v_lam=state.dyn_f2v_lam,
        obs_f2v_eta=state.obs_f2v_eta, obs_f2v_lam=state.obs_f2v_lam,
        trk_f2v_eta=state.trk_f2v_eta, trk_f2v_lam=state.trk_f2v_lam,
        ext_inbox=state.ext_inbox,
    )
    upd = VU.update_beliefs(eta, lam, state.belief_mean)
    belief_mean = _where_rows(gate, upd.mean, state.belief_mean)
    return replace(
        state,
        belief_eta=_where_rows(gate, upd.eta, state.belief_eta),
        belief_lam=_where_rows(gate, upd.lam, state.belief_lam),
        belief_mean=belief_mean,
        ir_v2f_ext_pos=deliver_responses(state, params, gate, belief_mean[:, 1:, :2], comm),
    )


def deliver_responses(
    state: SimState, params: GbpParams, gate: torch.Tensor, own_pos: torch.Tensor,
    comm=LOCAL,
) -> torch.Tensor:
    """`ir_v2f_ext_pos` after the external variable pass under `gate`, with
    own_pos [R, V-1, 2] the new belief positions. The delivery condition
    gate[r] & gate[j] & both slots alive is symmetric in (r, j). Under
    "sender" the factor (r, k) receives j = nbr_idx[r, k]'s positions, one
    row gather (K4) of the same positions for every reciprocal slot; under
    the receiver exchanges the mirror of what the peer holds becomes MY
    positions, with no gather."""
    gate_all = comm.all_robots(gate)
    src = _clip_idx(state.nbr_idx, gate_all.shape[0])
    deliver = gate[:, None] & state.nbr_mask & gate_all[src] & state.nbr_has_back
    if params.ext_exchange != "sender":
        in_pos = own_pos[:, None]
    else:
        in_pos = _gather_rows_pinned(comm.all_robots(own_pos), src, state.nbr_mask)
    return torch.where(deliver[..., None, None], in_pos, state.ir_v2f_ext_pos)


def iterate_gbp(state: SimState, sdf: torch.Tensor, params: GbpParams, comm=LOCAL) -> SimState:
    """`iterate_gbp_v2` (robot.rs:1769-1861): run the iteration schedule,
    unrolled. Where `params.uses_kernels` holds (by default on CUDA) the
    slots run on the hot layout through the hand-written kernels
    (kernels/hot.py). `scan_schedule` is the JAX package's compile-size
    knob; the slots run unrolled whatever it says."""
    if not params.schedule:
        return state
    if params.uses_kernels(state.device):
        from magics_tpu_torch.kernels.hot import iterate_gbp_hot

        return iterate_gbp_hot(state, sdf, params, comm=comm)

    for internal_flag, external_flag in params.schedule:
        if internal_flag:
            state = internal_factor_pass(state, sdf, params)
            state = internal_variable_pass(state, params, comm)
        if external_flag:
            state = external_factor_pass(state, params, comm)
            state = external_variable_pass(state, params, comm)
    return state


# --------------------------------------------------------------------------
# counters, collisions, goal areas, logs
# --------------------------------------------------------------------------

def update_message_counts(state: SimState, params: GbpParams, comm=LOCAL) -> SimState:
    """Per-robot message counters [R, 4] = (internal sent, external sent,
    internal received, external received), accumulated once per tick in
    closed form (magics_tpu tick.py:update_message_counts)."""
    V = state.prior_mean.shape[1]
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e)
    if n_int == 0 and n_ext == 0:
        return state
    i32 = torch.int32

    gate = (state.active & _not_idle(state)).to(i32)
    k_active = state.nbr_mask.sum(dim=1).to(i32)

    per_factor_msgs = 0
    if params.dynamic_enabled:
        per_factor_msgs += 2 * (V - 1)
    if params.obstacle_enabled and V > 2:
        per_factor_msgs += V - 2
    if params.tracking_enabled and V > 2:
        per_factor_msgs += V - 2
    internal = n_int * (gate * (2 * per_factor_msgs) + gate * k_active * (V - 1))

    send_gate = (state.active & state.antenna & _not_idle(state)).to(i32)
    ext_sent = torch.zeros_like(internal)
    ext_recv = torch.zeros_like(internal)
    if params.interrobot_enabled and n_ext > 0:
        send_gate_all = comm.all_robots(send_gate)
        src = _clip_idx(state.nbr_idx, send_gate_all.shape[0])
        produced = send_gate[:, None] * state.nbr_mask.to(i32)
        deliver = (
            (send_gate[:, None] > 0)
            & state.nbr_mask
            & (send_gate_all[src] > 0)
            & state.nbr_has_back
        ).to(i32)
        n_prod = produced.sum(dim=1).to(i32)
        n_del = deliver.sum(dim=1).to(i32)
        ext_sent = n_ext * (n_prod * (V - 1) + n_del * (V - 1))
        ext_recv = n_ext * (2 * n_del * (V - 1))

    counts = torch.stack([internal, ext_sent, internal, ext_recv], dim=1).to(i32)
    return replace(state, msg_counts=state.msg_counts + counts)


def update_collisions(
    state: SimState, params: GbpParams, env_dist: torch.Tensor | None = None,
    comm=LOCAL,
) -> SimState:
    """Robot-robot (bounding discs) and robot-environment collision events
    with hysteresis (collisions.rs:72-140,146-227), dense [R, R], with the
    event AABB records where `collision_log_capacity > 0`."""
    Rl = state.pos.shape[0]
    dev = state.device
    pos_all = comm.all_robots(state.pos)
    rad_all = comm.all_robots(state.radius)
    act_all = comm.all_robots(state.active)
    R = act_all.shape[0]
    me = comm.row_ids(Rl, dev)
    cols = torch.arange(R, dtype=torch.int32, device=dev)

    diff = state.pos[:, None, :] - pos_all[None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    rsum = state.radius[:, None] + rad_all[None, :]
    upper = cols[None, :] > me[:, None]
    pair_overlap = (d2 < rsum * rsum) & upper & state.active[:, None] & act_all[None, :]
    new_pair = pair_overlap & ~state.rr_overlap
    new_events = comm.psum(new_pair.sum())
    rr_count = (
        state.rr_count
        + new_pair.sum(dim=1).to(torch.int32)
        + comm.scatter_rows(new_pair.sum(dim=0)).to(torch.int32)
    )
    updates = dict(
        rr_overlap=pair_overlap,
        rr_collisions=state.rr_collisions + new_events.to(torch.int32),
        rr_count=rr_count,
    )
    if state.rr_events.shape[0] > 0:
        _refuse_sharded_events(comm)
        ii = torch.arange(R, device=dev)
        updates.update(_rr_event_updates(
            state, new_pair.reshape(-1),
            ii[:, None].expand(R, R).reshape(-1), ii[None, :].expand(R, R).reshape(-1),
        ))
    if env_dist is not None:
        updates.update(_env_collision_updates(state, params, env_dist, comm))
    return replace(state, **updates)


def _refuse_sharded_events(comm) -> None:
    """The event rings' write order is global, so they are kept on one
    device only (magics_tpu tick.py:1298-1301, 1436-1440; the environment
    ring too, which the JAX package guards in `make_shard_step`)."""
    if getattr(comm, "n_shards", 1) > 1:
        raise NotImplementedError(
            "collision event AABB recording is single-shard only "
            "(set collision_log_capacity=0 for sharded runs)"
        )


def _ring_append(ring: torch.Tensor, count: torch.Tensor, flat: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """`ring` [C, w] with the `rows` [N, w] where `flat` [N] holds appended
    in order after the `count` events already written, wrapping at C (the
    JAX `ring.at[slot].set(rows, mode="drop")` with slot (count + rank) % C,
    C where not `flat`). Where one tick appends more than C events, the last
    C are kept, as a scatter applied in order leaves them. The rows that are
    not written go to a spare row C, sliced off: a CUDA scatter asserts on
    an index out of range, and no real row may be clamped onto."""
    C = ring.shape[0]
    flat_i = flat.to(torch.int64)
    rank = torch.cumsum(flat_i, dim=0) - 1
    n = rank[-1] + 1
    write = flat & (rank >= n - C)
    slot = torch.where(write, (count.to(torch.int64) + rank) % C, torch.full_like(rank, C))
    out = torch.cat([ring, ring.new_zeros((1, ring.shape[1]))])
    out[slot] = rows.to(ring.dtype)
    return out[:C]


def _rr_event_updates(state: SimState, flat, a_idx, b_idx) -> dict:
    """The robot-robot event records (export.rs:171-185): for each new pair
    (a, b) where `flat`, the intersection box of the two discs' AABBs and
    the tick, [a, b, min x, min y, max x, max y, tick], appended to the
    ring. The ring's write order is global: one device only, as the JAX
    package refuses the records on a sharded mesh."""
    f = state.pos.dtype
    pa, ra = state.pos[a_idx], state.radius[a_idx]
    pb, rb = state.pos[b_idx], state.radius[b_idx]
    mn = torch.maximum(pa - ra[:, None], pb - rb[:, None])
    mx = torch.minimum(pa + ra[:, None], pb + rb[:, None])
    rows = torch.cat([
        a_idx[:, None].to(f), b_idx[:, None].to(f), mn, mx,
        state.tick.to(f).expand(flat.shape[0])[:, None],
    ], dim=1)
    return dict(
        rr_events=_ring_append(state.rr_events, state.rr_event_count, flat, rows),
        rr_event_count=state.rr_event_count + flat.sum().to(torch.int32),
    )


def _env_collision_updates(
    state: SimState, params: GbpParams, env_dist: torch.Tensor, comm=LOCAL
) -> dict:
    """Robot-environment overlap via the euclidean distance field
    (collisions.rs:108-140), shared by the dense and grid paths, with the
    event records [robot, min x, min y, max x, max y, tick] of the discs'
    AABBs where `collision_log_capacity > 0`."""
    R = state.pos.shape[0]
    H, W = env_dist.shape
    ww, wh = params.world_width, params.world_height
    xf = (state.pos[:, 0] + ww / 2.0) * (W / ww)
    yf = (-state.pos[:, 1] + wh / 2.0) * (H / wh)
    # clip then truncate, like jnp.clip(...).astype(int32)
    xi = xf.clamp(0, W - 1).to(torch.int32).long()
    yi = yf.clamp(0, H - 1).to(torch.int32).long()
    re_overlap = state.active & (env_dist[yi, xi] < state.radius)
    new_re = re_overlap & ~state.re_overlap
    updates = dict(
        re_overlap=re_overlap,
        re_collisions=state.re_collisions + comm.psum(new_re.sum()).to(torch.int32),
        re_count=state.re_count + new_re.to(torch.int32),
    )
    if state.re_events.shape[0] > 0:
        _refuse_sharded_events(comm)
        f = state.pos.dtype
        r = state.radius[:, None]
        rows = torch.cat([
            torch.arange(R, dtype=f, device=state.device)[:, None],
            state.pos - r, state.pos + r, state.tick.to(f).expand(R)[:, None],
        ], dim=1)
        updates["re_events"] = _ring_append(state.re_events, state.re_event_count, new_re, rows)
        updates["re_event_count"] = state.re_event_count + new_re.sum().to(torch.int32)
    return updates


def update_collisions_grid(
    state: SimState, params: GbpParams, env_dist: torch.Tensor | None = None,
    comm=LOCAL, candidates=None,
) -> SimState:
    """Grid collision events (magics_tpu tick.py:update_collisions_grid):
    hysteresis by a per-robot table of the P lowest currently overlapping
    partner ids, [R, P], instead of the dense [R, R] matrix. An event counts
    where a partner enters the table, once per pair (a < b); overlaps past P
    are counted in `rr_partner_overflow`."""
    Rl = state.pos.shape[0]
    P = state.rr_partner.shape[1]
    R = comm.all_robots(state.active).shape[0]
    cand_idx, cand_pos, cand_rad, cand_mask = (
        candidates if candidates is not None else grid_candidates(state, params, comm)
    )
    diff = state.pos[:, None, :] - cand_pos
    d2 = (diff * diff).sum(dim=-1)
    rsum = state.radius[:, None] + cand_rad
    overlap = cand_mask & (d2 < rsum * rsum)                 # [Rl, M]

    # the P lowest overlapping ids (only the values count, so ties among the
    # R fillers do not matter), padded with R where M < P
    key = torch.where(overlap, cand_idx, torch.full_like(cand_idx, R))
    cur = torch.topk(key, min(P, key.shape[1]), dim=1, largest=False, sorted=True).values
    if cur.shape[1] < P:
        cur = torch.cat([cur, cur.new_full((Rl, P - cur.shape[1]), R)], dim=1)
    cur = torch.where(cur < R, cur, torch.full_like(cur, -1)).to(torch.int32)
    n_overlap = overlap.sum(dim=1).to(torch.int32)
    dropped = torch.clamp(n_overlap - P, min=0).sum()

    prev = state.rr_partner
    is_new = (cur >= 0) & ~(cur[:, :, None] == prev[:, None, :]).any(dim=-1)
    me = comm.row_ids(Rl, state.device)[:, None]
    once = is_new & (cur > me)                               # each pair once
    updates = dict(
        rr_partner=cur,
        rr_collisions=state.rr_collisions + comm.psum(once.sum()).to(torch.int32),
        rr_count=state.rr_count + is_new.sum(dim=1).to(torch.int32),
        rr_partner_overflow=state.rr_partner_overflow + comm.psum(dropped).to(torch.int32),
    )
    if state.rr_events.shape[0] > 0:
        _refuse_sharded_events(comm)
        updates.update(_rr_event_updates(
            state, once.reshape(-1), me.long().expand(R, P).reshape(-1),
            cur.clamp(0, R - 1).long().reshape(-1),
        ))
    if env_dist is not None:
        updates.update(_env_collision_updates(state, params, env_dist, comm))
    return replace(state, **updates)


def update_goal_areas(state: SimState, params: GbpParams) -> SimState:
    """Goal-area intersection check (goal_area.rs:67-104): a robot disc
    intersecting an area's AABB records the first-reach timestamp."""
    if state.ga_aabb.shape[0] == 0:
        return state
    mn = state.ga_aabb[:, None, 0:2]
    mx = state.ga_aabb[:, None, 2:4]
    p = state.pos[None, :, :]
    clamped = torch.minimum(torch.maximum(p, mn), mx)
    d2 = ((p - clamped) ** 2).sum(dim=-1)
    hit = state.active[None, :] & (d2 <= state.radius[None, :] ** 2)
    now = state.tick.to(state.ga_history.dtype) / params.hz
    first = hit & (state.ga_history < 0)
    return replace(state, ga_history=torch.where(first, now, state.ga_history))


def log_positions(state: SimState, params: GbpParams) -> SimState:
    """Sample positions + velocities (and, with viz_log_capacity, variable
    position means, marginal position covariances and tracking measurement
    points) into the on-device ring buffers every `log_every` ticks
    (tracking.rs:48-110,156-203). Inactive robots log NaN. The write index
    stays a tensor, so logging never syncs with the host."""
    if params.log_every <= 0 or params.log_capacity <= 0:
        return state
    f32 = torch.float32
    nan = float("nan")
    do_log = (state.tick % params.log_every) == 0
    zero = torch.zeros_like(state.log_head)
    idx = torch.where(do_log, state.log_head % params.log_capacity, zero).long()
    alive = state.active[:, None]
    sample = torch.where(alive, state.pos.to(f32), nan)
    vel = torch.where(alive, state.belief_mean[:, 0, 2:4].to(f32), nan)

    def ring_write(log, i, row):
        # by index_select / index_copy: indexing with a 0-dim tensor may
        # read it on the host
        i = i.reshape(1)
        return log.index_copy(0, i, torch.where(do_log, row, log.index_select(0, i)[0])[None])

    updates = dict(
        pos_log=ring_write(state.pos_log, idx, sample),
        vel_log=ring_write(state.vel_log, idx, vel),
        log_head=state.log_head + do_log.to(torch.int32),
    )
    Lv = state.viz_mean.shape[0]
    if Lv > 0:
        vidx = torch.where(do_log, state.log_head % Lv, zero).long()
        a2 = state.active[:, None, None]
        # row-scaled inverse: the pinned endpoints carry precision 1e30
        cov, _ = inv4_rowscaled(state.belief_lam)
        cov3 = torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]], dim=-1)
        updates["viz_mean"] = ring_write(
            state.viz_mean, vidx, torch.where(a2, state.belief_mean[..., :2].to(f32), nan)
        )
        updates["viz_cov"] = ring_write(state.viz_cov, vidx, torch.where(a2, cov3.to(f32), nan))
        updates["viz_trk"] = ring_write(
            state.viz_trk, vidx, torch.where(a2, state.trk_last_pos.to(f32), nan)
        )
    return replace(state, **updates)


# --------------------------------------------------------------------------
# the full tick
# --------------------------------------------------------------------------

def _pin_fp32_matmul() -> None:
    # The JAX step pins matmul precision to "highest": a float32 product in
    # TF32 keeps ~3 decimal digits, the covariance residual check then
    # rejects every inverse and beliefs stop moving. The port's products are
    # multiply-sums, but no library matmul or convolution on the card path may
    # round to TF32 either, so both switches are set explicitly.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def step(
    state: SimState,
    sdf: torch.Tensor,
    params: GbpParams,
    env_dist: torch.Tensor | None = None,
    comm=LOCAL,
    generator: torch.Generator | None = None,
) -> SimState:
    """One FixedUpdate tick (robot.rs:86-108 system chain). `generator`
    drives the comms-failure draws and is needed when
    comms_failure_rate > 0. Grid connectivity and collisions each build
    their candidate tables at their own point of the chain, as in JAX
    (collisions see the positions update_prior_current moved)."""
    if state.pos.is_cuda:
        params.check_kernels(state.device)
        _pin_fp32_matmul()
    state = activate_due_spawns(state)
    state = check_waypoints(state, params)
    if params.use_grid:
        state = update_connectivity_grid(state, params, comm)
    else:
        state = update_connectivity(state, params, comm)
    state = update_failed_comms(state, params, comm, generator)
    state = update_prior_horizon(state, params, comm)
    state = update_prior_current(state, params)
    state = iterate_gbp(state, sdf, params, comm)
    state = update_message_counts(state, params, comm)
    if params.use_grid:
        state = update_collisions_grid(state, params, env_dist, comm)
    else:
        state = update_collisions(state, params, env_dist, comm)
    state = update_goal_areas(state, params)
    state = log_positions(state, params)
    return replace(state, tick=state.tick + 1)


def run_ticks(
    state: SimState,
    sdf: torch.Tensor,
    params: GbpParams,
    n: int,
    env_dist: torch.Tensor | None = None,
    comm=LOCAL,
    generator: torch.Generator | None = None,
) -> SimState:
    """Run `n` ticks eagerly: a Python loop over `step`; nothing syncs with
    the host between ticks unless the caller reads a value. On the card,
    graph/chunk.py:compile_ticks captures the same loop as one CUDA graph
    (the counterpart of `jax.jit` over the JAX package's `lax.scan`)."""
    for _ in range(n):
        state = step(state, sdf, params, env_dist, comm, generator)
    return state

"""Dense batched representation of all robots' factor graphs (counterpart of
magics_tpu's graph/state.py).

The same layout as the JAX package, as torch tensors on one device:

  R — robot capacity (`active` masks live robots)
  V — variables per robot chain (current state .. horizon)
  K — inter-robot neighbour slots per robot (masked, fixed capacity)
  W — max waypoints per robot route / tracking path

Field names, shapes and meanings are those of magics_tpu's `SimState`, whose
docstrings explain them, except that there is no `rng`: the comms-failure
draws take a `torch.Generator` passed to `tick.step` explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from magics_tpu_torch.core.constants import DOFS


def _kernels_take(n_vars: int, dtype: torch.dtype) -> str | None:
    from magics_tpu_torch.kernels.gbp_slot import kernels_take

    return kernels_take(n_vars, dtype)


@dataclasses.dataclass(frozen=True)
class GbpParams:
    """Static per-scenario parameters (hashable). The same fields and
    defaults as magics_tpu's `GbpParams`, with `dtype` a `torch.dtype`, but
    `use_pallas`, which defaults to None: the kernels on a CUDA state whose
    dtype and V they take, the plain passes otherwise."""

    n_vars: int  # V
    n_slots: int  # K
    max_waypoints: int  # W

    sigma_pose_fixed: float = 1e-15
    sigma_factor_dynamics: float = 0.1
    sigma_factor_interrobot: float = 0.01
    sigma_factor_obstacle: float = 0.01
    sigma_factor_tracking: float = 0.1
    lookahead_multiple: int = 3

    dynamic_enabled: bool = True
    interrobot_enabled: bool = True
    obstacle_enabled: bool = True
    tracking_enabled: bool = True

    tracking_switch_padding: float = 1.0
    tracking_attraction_distance: float = 2.0

    # static tuple of (internal, external) booleans per micro-iteration
    schedule: tuple[tuple[bool, bool], ...] = ()

    log_every: int = 0
    log_capacity: int = 0
    collision_log_capacity: int = 0
    viz_log_capacity: int = 0

    target_speed: float = 4.0
    planning_horizon_seconds: float = 5.0
    comms_radius: float = 20.0
    comms_failure_rate: float = 0.2
    safety_distance_multiplier: float = 2.2

    variable_timesteps: tuple[int, ...] = ()

    hz: float = 60.0
    despawn_on_final_waypoint: bool = True

    world_width: float = 100.0
    world_height: float = 100.0
    sdf_shape: tuple[int, int] = (200, 200)

    dtype: torch.dtype = torch.float32

    # "sender" | "receiver" | "receiver_compact" (magics_tpu graph/state.py);
    # the port carries all three and refuses any other name.
    ext_exchange: str = "sender"

    # Run the GBP slots through the hand-written kernels (graph/gbp.py)
    # on the hot layout: True or False as asked; None (the default) for the
    # kernels on a CUDA state whose dtype and V they take, the plain passes
    # otherwise, as the JAX package runs XLA (`uses_kernels`). True asks for
    # the kernels' path: on a CPU state its wrappers run their plain
    # versions, which take any dtype and V; on a CUDA state it runs the
    # kernels, and a V they do not take raises here, a dtype at the first
    # point that knows the device (`check_kernels`). `pallas_interpret` and
    # `pallas_r_tile` keep the JAX field names; the port's kernels mask the
    # ragged robot edge themselves and read neither.
    use_pallas: bool | None = None
    pallas_interpret: bool = False
    pallas_r_tile: int = 128

    grid_cell_size: float = 0.0
    grid_capacity: int = 16
    collision_partners: int = 8
    max_robot_radius: float = 1.0

    # lowers runs of identical slots to lax.scan in the JAX package (compile
    # size only); the port runs the same slots unrolled either way
    scan_schedule: bool = False

    def __post_init__(self) -> None:
        if self.ext_exchange not in ("sender", "receiver", "receiver_compact"):
            raise ValueError(f"unknown ext_exchange {self.ext_exchange!r}")
        if self.use_pallas:
            reason = _kernels_take(self.n_vars, torch.float32)
            if reason is not None:
                raise ValueError(f"use_pallas=True: {reason}")

    def uses_kernels(self, device: torch.device) -> bool:
        """Whether the GBP slots of a state on `device` run on the kernels'
        path: `use_pallas` where it was given, else only on CUDA and only
        where the kernels take this dtype and V."""
        if self.use_pallas is None:
            return device.type == "cuda" and _kernels_take(self.n_vars, self.dtype) is None
        return self.use_pallas

    def check_kernels(self, device: torch.device) -> None:
        """Raise where `use_pallas=True` asks for kernels on the card that do
        not take this state's dtype (a CPU state runs the plain versions)."""
        if self.use_pallas and device.type == "cuda":
            reason = _kernels_take(self.n_vars, self.dtype)
            if reason is not None:
                raise ValueError(f"use_pallas=True on {device}: {reason}")

    @property
    def use_grid(self) -> bool:
        return self.grid_cell_size > 0.0

    @property
    def dt(self) -> float:
        return 1.0 / self.hz


@dataclasses.dataclass(frozen=True)
class SimState:
    """All mutable simulation state as tensors on one device."""

    # --- per-robot scalars
    active: torch.Tensor          # [R] bool
    mission_active: torch.Tensor  # [R] bool
    completed: torch.Tensor       # [R] bool
    finished_at: torch.Tensor     # [R] f
    spawn_tick: torch.Tensor      # [R] i32
    pos: torch.Tensor             # [R, 2]
    radius: torch.Tensor          # [R]
    t0: torch.Tensor              # [R]
    antenna: torch.Tensor         # [R] bool
    iter_count_factor: torch.Tensor  # [R] i32
    plan_pending: torch.Tensor    # [R] bool

    # --- mission / route
    waypoints: torch.Tensor       # [R, W, 4]
    n_waypoints: torch.Tensor     # [R] i32
    target_idx: torch.Tensor      # [R] i32
    wp_check_var: torch.Tensor    # [R] i32
    wp_check_dist2: torch.Tensor  # [R]
    fin_check_var: torch.Tensor   # [R] i32
    fin_check_dist2: torch.Tensor  # [R]

    # --- variables
    prior_mean: torch.Tensor      # [R, V, 4]
    prior_sigma: torch.Tensor     # [R, V]
    belief_eta: torch.Tensor      # [R, V, 4]
    belief_lam: torch.Tensor      # [R, V, 4, 4]
    belief_mean: torch.Tensor     # [R, V, 4]
    snap_eta: torch.Tensor        # [R, V, 4]
    snap_lam: torch.Tensor        # [R, V, 4, 4]
    snap_mu: torch.Tensor         # [R, V, 4]

    # --- dynamic factors (i connects vars i, i+1)
    dyn_v2f_eta: torch.Tensor     # [R, V-1, 2, 4]
    dyn_v2f_lam: torch.Tensor     # [R, V-1, 2, 4, 4]
    dyn_v2f_mu: torch.Tensor      # [R, V-1, 2, 4]
    dyn_f2v_eta: torch.Tensor     # [R, V-1, 2, 4]
    dyn_f2v_lam: torch.Tensor     # [R, V-1, 2, 4, 4]

    # --- obstacle factors (unary on vars 1..V-2)
    obs_v2f_mu: torch.Tensor      # [R, V-2, 4]
    obs_f2v_eta: torch.Tensor     # [R, V-2, 4]
    obs_f2v_lam: torch.Tensor     # [R, V-2, 4, 4]

    # --- tracking factors (unary on vars 1..V-2)
    trk_v2f_mu: torch.Tensor      # [R, V-2, 4]
    trk_f2v_eta: torch.Tensor     # [R, V-2, 4]
    trk_f2v_lam: torch.Tensor     # [R, V-2, 4, 4]
    trk_record: torch.Tensor      # [R, V-2] i32
    trk_timeout: torch.Tensor     # [R, V-2] i32
    trk_index: torch.Tensor       # [R] i32
    trk_last_pos: torch.Tensor    # [R, V-2, 2]
    trk_last_val: torch.Tensor    # [R, V-2]
    trk_path: torch.Tensor        # [R, W, 2]
    trk_path_len: torch.Tensor    # [R] i32

    # --- inter-robot connections
    nbr_idx: torch.Tensor         # [R, K] i32, -1 empty
    nbr_mask: torch.Tensor        # [R, K] bool
    nbr_back: torch.Tensor        # [R, K] i32
    nbr_has_back: torch.Tensor    # [R, K] bool
    nbr_overflow: torch.Tensor    # [] i32
    grid_overflow: torch.Tensor   # [] i32
    ir_int_seeded: torch.Tensor   # [R, K, V-1] bool
    ir_v2f_ext_pos: torch.Tensor  # [R, K, V-1, 2]
    ir_f2v_ext: torch.Tensor      # [R, K, V-1, 4]
    ext_inbox: torch.Tensor       # [R, K, V-1, 4]

    # --- bookkeeping
    tick: torch.Tensor            # [] i32
    pos_log: torch.Tensor         # [L, R, 2] f32
    vel_log: torch.Tensor         # [L, R, 2] f32
    log_head: torch.Tensor        # [] i32
    viz_mean: torch.Tensor        # [Lv, R, V, 2] f32
    viz_cov: torch.Tensor         # [Lv, R, V, 3] f32
    viz_trk: torch.Tensor         # [Lv, R, V-2, 2] f32
    msg_counts: torch.Tensor      # [R, 4] i32
    rr_collisions: torch.Tensor   # [] i32
    re_collisions: torch.Tensor   # [] i32
    rr_count: torch.Tensor        # [R] i32
    re_count: torch.Tensor        # [R] i32
    rr_overlap: torch.Tensor      # [R, R] bool (dense) / [R, 0] (grid)
    rr_partner: torch.Tensor      # [R, P] i32 (grid) / [R, 0] (dense)
    rr_partner_overflow: torch.Tensor  # [] i32
    re_overlap: torch.Tensor      # [R] bool
    rr_events: torch.Tensor       # [C, 7] f32
    rr_event_count: torch.Tensor  # [] i32
    re_events: torch.Tensor       # [C, 6] f32
    re_event_count: torch.Tensor  # [] i32
    ga_aabb: torch.Tensor         # [G, 4]
    ga_history: torch.Tensor      # [G, R]

    @property
    def n_robots(self) -> int:
        return self.active.shape[0]

    @property
    def n_vars(self) -> int:
        return self.prior_mean.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device


def require_device(device: torch.device | str) -> torch.device:
    """The device an entry point builds on. A CUDA device that is not there
    raises: the entry points never carry on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def init_state(
    params: GbpParams,
    *,
    n_robots: int,
    start_states: np.ndarray,      # [R, 4] initial pose+velocity
    waypoints: np.ndarray,         # [R, W, 4]
    n_waypoints: np.ndarray,       # [R] i32
    radii: np.ndarray,             # [R]
    spawn_ticks: np.ndarray,       # [R] i32
    variable_timesteps: np.ndarray,  # [V] i32
    wp_check_var: np.ndarray,      # [R] i32
    wp_check_dist2: np.ndarray,    # [R]
    fin_check_var: np.ndarray,     # [R] i32
    fin_check_dist2: np.ndarray,   # [R]
    device: torch.device | str = "cuda",
    goal_areas: np.ndarray | None = None,  # [G, 4]
    plan_pending: np.ndarray | None = None,  # [R] bool
) -> SimState:
    """Build the initial dense state for a scenario (magics_tpu
    graph/state.py:init_state): variables interpolated from start towards the
    horizon point, endpoint priors pinned at 1e30, interior priors zero, all
    messages empty except the tracking factors' initial v2f mean. The maths is
    numpy in float64; every field ends in `torch.as_tensor(..., device=)`."""
    device = require_device(device)
    params.check_kernels(device)
    R, V, K, W = n_robots, params.n_vars, params.n_slots, params.max_waypoints
    f = params.dtype
    if variable_timesteps.shape[0] != V:
        raise ValueError(f"{variable_timesteps.shape[0]} timesteps for V={V}")

    start = start_states.astype(np.float64)  # [R, 4]
    first_wp = waypoints[np.arange(R), np.minimum(1, n_waypoints - 1)].astype(np.float64)

    start2goal = first_wp - start
    dist = np.linalg.norm(start2goal, axis=-1, keepdims=True)
    ph_speed = params.target_speed * params.planning_horizon_seconds
    direction = np.where(dist > 0, start2goal / np.maximum(dist, 1e-30), 0.0)
    horizon = start + np.minimum(dist, ph_speed) * direction

    ts = variable_timesteps.astype(np.float64)
    frac = ts / max(float(ts[-1]), 1.0)  # [V]
    means = start[:, None, :] + (horizon - start)[:, None, :] * frac[None, :, None]

    prior_sigma = np.zeros((R, V), dtype=np.float64)
    prior_sigma[:, 0] = 1e30
    prior_sigma[:, -1] = 1e30

    belief_lam = np.einsum("rv,ij->rvij", prior_sigma, np.eye(DOFS))
    belief_eta = prior_sigma[..., None] * means
    Vm1, Vm2 = V - 1, max(V - 2, 0)
    i32 = torch.int32

    def t(x, dtype=f):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    def zeros(*shape, dtype=f):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return SimState(
        active=zeros(R, dtype=torch.bool),
        mission_active=zeros(R, dtype=torch.bool),
        completed=zeros(R, dtype=torch.bool),
        finished_at=full((R,), -1.0, f),
        spawn_tick=t(spawn_ticks, i32),
        pos=t(start[:, :2]),
        radius=t(radii),
        t0=t(radii / 2.0 / params.target_speed),
        antenna=full((R,), True, torch.bool),
        iter_count_factor=zeros(R, dtype=i32),
        plan_pending=(
            t(plan_pending, torch.bool)
            if plan_pending is not None
            else zeros(R, dtype=torch.bool)
        ),
        waypoints=t(waypoints),
        n_waypoints=t(n_waypoints, i32),
        target_idx=full((R,), 1, i32),
        wp_check_var=t(wp_check_var, i32),
        wp_check_dist2=t(wp_check_dist2),
        fin_check_var=t(fin_check_var, i32),
        fin_check_dist2=t(fin_check_dist2),
        prior_mean=t(means),
        prior_sigma=t(prior_sigma),
        belief_eta=t(belief_eta),
        belief_lam=t(belief_lam),
        belief_mean=t(means),
        snap_eta=t(belief_eta),
        snap_lam=t(belief_lam),
        snap_mu=t(means),
        dyn_v2f_eta=zeros(R, Vm1, 2, DOFS),
        dyn_v2f_lam=zeros(R, Vm1, 2, DOFS, DOFS),
        dyn_v2f_mu=zeros(R, Vm1, 2, DOFS),
        dyn_f2v_eta=zeros(R, Vm1, 2, DOFS),
        dyn_f2v_lam=zeros(R, Vm1, 2, DOFS, DOFS),
        obs_v2f_mu=zeros(R, Vm2, DOFS),
        obs_f2v_eta=zeros(R, Vm2, DOFS),
        obs_f2v_lam=zeros(R, Vm2, DOFS, DOFS),
        trk_v2f_mu=t(means[:, 1 : V - 1, :]),
        trk_f2v_eta=zeros(R, Vm2, DOFS),
        trk_f2v_lam=zeros(R, Vm2, DOFS, DOFS),
        trk_record=zeros(R, Vm2, dtype=i32),
        trk_timeout=full((R, Vm2), -1, i32),
        trk_index=full((R,), 1, i32),
        trk_last_pos=t(means[:, 1 : V - 1, :2]),
        trk_last_val=zeros(R, Vm2),
        trk_path=t(waypoints[:, :, :2]),
        trk_path_len=t(n_waypoints, i32),
        nbr_idx=full((R, K), -1, i32),
        nbr_mask=zeros(R, K, dtype=torch.bool),
        nbr_back=zeros(R, K, dtype=i32),
        nbr_has_back=zeros(R, K, dtype=torch.bool),
        nbr_overflow=zeros(dtype=i32),
        grid_overflow=zeros(dtype=i32),
        ir_int_seeded=zeros(R, K, Vm1, dtype=torch.bool),
        ir_v2f_ext_pos=zeros(R, K, Vm1, 2),
        ir_f2v_ext=zeros(R, K, Vm1, DOFS),
        ext_inbox=zeros(R, K, Vm1, DOFS),
        tick=zeros(dtype=i32),
        pos_log=full((params.log_capacity, R, 2), float("nan"), torch.float32),
        vel_log=full((params.log_capacity, R, 2), float("nan"), torch.float32),
        log_head=zeros(dtype=i32),
        viz_mean=full((params.viz_log_capacity, R, V, 2), float("nan"), torch.float32),
        viz_cov=full((params.viz_log_capacity, R, V, 3), float("nan"), torch.float32),
        viz_trk=full((params.viz_log_capacity, R, Vm2, 2), float("nan"), torch.float32),
        msg_counts=zeros(R, 4, dtype=i32),
        rr_collisions=zeros(dtype=i32),
        re_collisions=zeros(dtype=i32),
        rr_count=zeros(R, dtype=i32),
        re_count=zeros(R, dtype=i32),
        rr_overlap=zeros(R, 0 if params.use_grid else R, dtype=torch.bool),
        rr_partner=full(
            (R, params.collision_partners if params.use_grid else 0), -1, i32
        ),
        rr_partner_overflow=zeros(dtype=i32),
        re_overlap=zeros(R, dtype=torch.bool),
        rr_events=zeros(params.collision_log_capacity, 7, dtype=torch.float32),
        rr_event_count=zeros(dtype=i32),
        re_events=zeros(params.collision_log_capacity, 6, dtype=torch.float32),
        re_event_count=zeros(dtype=i32),
        ga_aabb=t(goal_areas if goal_areas is not None else np.zeros((0, 4))),
        ga_history=full(
            ((0 if goal_areas is None else len(goal_areas)), R), -1.0, f
        ),
    )

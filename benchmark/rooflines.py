"""The work of the GBP slot operations, frozen from chip_smoke.py (its
`slot_bytes`, `internal_slot_bytes`, `variable_slot_bytes` and
`OPS_PER_ITEM`, reviewed when the kernels were redesigned), on robot-major
fields [R, ...] instead of the kernels' hot layout: a field's bytes per
robot are its entries over R times its element size either way.

The bytes an operation needs at its inputs: each output written once, each
input read once for the robots that need it (the passthrough inputs of a
gated-on robot, the old messages of a factor it recomputes, are not read).
The operations: per robot and variable, 1,640 for the internal slot (two
dynamic messages of a 4x4 inverse and three 4x4 products each, the belief
update's inverse, residual and sums, obstacle and tracking) and 400 for
the variable slot. A slot's least time is the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s."""

from __future__ import annotations

import torch

from benchmark.harness import FP32_OPS_PER_S, HBM_BYTES_PER_S
from benchmark.reference import factors as RF
from benchmark.reference import linalg as RL

OPS_PER_ITEM = {"internal_slot": 1640, "variable_slot": 400}

#: what each slot writes, a field of the state's size each
INTERNAL_OUT = (
    "belief_eta", "belief_lam", "belief_mean", "snap_eta", "snap_lam", "snap_mu",
    "dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu", "dyn_f2v_eta", "dyn_f2v_lam",
    "obs_v2f_mu", "obs_f2v_eta", "obs_f2v_lam", "trk_v2f_mu", "trk_f2v_eta", "trk_f2v_lam",
    "trk_record", "trk_timeout", "trk_last_pos", "trk_last_val",
)
VARIABLE_OUT = ("belief_eta", "belief_lam", "belief_mean")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def belief_validity(belief_lam: torch.Tensor) -> torch.Tensor:
    """[R, V] guard decision of a belief update from its precision [R, V,
    4, 4]: some entry > 1e-6 and the residual-checked inverse holds."""
    _, ok = RL.belief_covariance(belief_lam)
    return (belief_lam > 1e-6).any(dim=-1).any(dim=-1) & ok


def slot_bytes(h: dict, out: dict, valid: torch.Tensor, need: dict) -> int:
    """The bytes a slot must move: `h` its inputs and `out` its outputs,
    robot-major; `valid` [R, V] the new beliefs' guard; `need` maps a field
    to [(robots [R] bool, share of a robot's entries)]. Every slot reads
    the gate, a gated-off robot's old belief, a gated-on robot's prior and
    external sum, and the old mean where the belief keeps it."""
    gate = h["gate"][:, 0] > 0
    every = torch.ones_like(gate)
    need = {
        "gate": [(every, 1)], "belief_eta": [(~gate, 1)], "belief_lam": [(~gate, 1)],
        **{n: [(gate, 1)] for n in ("prior_mean", "prior_sigma", "ext_sum_eta", "ext_sum_lam")},
        **need,
    }
    total = nbytes(out.values())
    for name, parts in need.items():
        x = h[name]
        per_robot = x.numel() // x.shape[0] * x.element_size()
        total += sum(int(mask.sum()) * per_robot * share for mask, share in parts)
    old_mean = ~gate[:, None] | ~valid
    mean = h["belief_mean"]   # [R, V, 4]
    return int(total) + mean.shape[-1] * mean.element_size() * int(old_mean.sum())


def internal_slot_bytes(h: dict, out: dict, valid, sdf, world, flags: dict) -> int:
    """slot_bytes of the internal slot. A gated-on robot computes its
    dynamic and obstacle messages (the latter from the x, y of its
    linearisation points) and, where `tgate`, its tracking ones; a disabled
    factor's old messages are read. The tracking records count for every
    robot. The SDF counts the distinct pixels the live obstacle factors'
    taps read."""
    gate, tgate = h["gate"][:, 0] > 0, h["tgate"][:, 0] > 0
    every = torch.ones_like(gate)
    dyn, obs = gate & flags["dynamic"], gate & flags["obstacle"]
    trk = tgate & flags["tracking"]
    trk_kept = ~(gate & flags["tracking"])
    need = {
        "tgate": [(every if flags["tracking"] else ~every, 1)],
        "delta_t": [(dyn, 1)], "dyn_v2f_eta": [(every, 1)], "dyn_v2f_lam": [(every, 1)],
        "dyn_v2f_mu": [(~dyn, 1)], "dyn_f2v_eta": [(~dyn, 1)], "dyn_f2v_lam": [(~dyn, 1)],
        "obs_v2f_mu": [(obs, 0.5), (~obs, 1)],
        "obs_f2v_eta": [(~obs, 1)], "obs_f2v_lam": [(~obs, 1)],
        "trk_v2f_mu": [(trk | trk_kept, 1)],
        "trk_f2v_eta": [(~trk, 1)], "trk_f2v_lam": [(~trk, 1)],
        **{n: [(every, 1)] for n in ("trk_record", "trk_timeout", "trk_last_pos",
                                     "trk_last_val")},
        **{n: [(trk, 1)] for n in ("path_x", "path_y", "path_len")},
    }
    # the taps sample 1 - image: on an image of -(pixel number) each tap
    # inside the image gives its pixel's number + 1, outside 0
    ids = -torch.arange(1, sdf.numel() + 1, device=sdf.device, dtype=torch.float32)
    mu = h["obs_v2f_mu"][obs]
    taps = torch.stack(RF.obstacle_taps(mu, ids.view(sdf.shape), world))
    pixels = int(taps[taps > 0].unique().numel())
    return slot_bytes(h, out, valid, need) + sdf.element_size() * pixels


def variable_slot_bytes(h: dict, out: dict, valid) -> int:
    """slot_bytes of the variable slot: a gated-on robot sums every factor
    message to each variable."""
    gate = h["gate"][:, 0] > 0
    return slot_bytes(h, out, valid, {
        n: [(gate, 1)] for n in ("dyn_f2v_eta", "dyn_f2v_lam", "obs_f2v_eta", "obs_f2v_lam",
                                 "trk_f2v_eta", "trk_f2v_lam")})


def slot_fields(state, params) -> dict:
    """The slots' inputs, robot-major, from a state as the GBP schedule
    hands them over at a tick's start: every active robot that is not idle
    gated on, the external sums over the slots."""
    f = state.prior_mean.dtype
    R, V = state.prior_mean.shape[:2]
    names = (
        "belief_eta", "belief_lam", "belief_mean", "snap_eta", "snap_lam", "snap_mu",
        "prior_mean", "prior_sigma", "dyn_v2f_eta", "dyn_v2f_lam", "dyn_v2f_mu",
        "dyn_f2v_eta", "dyn_f2v_lam", "obs_v2f_mu", "obs_f2v_eta", "obs_f2v_lam",
        "trk_v2f_mu", "trk_f2v_eta", "trk_f2v_lam",
        "trk_record", "trk_timeout", "trk_last_pos", "trk_last_val",
    )
    h = {n: getattr(state, n) for n in names}
    gate = (state.active & (state.mission_active | state.completed)).to(f)[:, None]
    ts = torch.tensor(params.variable_timesteps, dtype=f, device=state.pos.device)
    h["delta_t"] = (ts[1:] - ts[:-1])[None, :] * state.t0[:, None]
    h["path_x"] = state.trk_path[..., 0]
    h["path_y"] = state.trk_path[..., 1]
    h["path_len"] = state.trk_path_len[:, None]
    h["gate"] = gate
    h["tgate"] = gate
    h["ext_sum_eta"] = torch.zeros(R, V, 4, dtype=f, device=state.pos.device)
    h["ext_sum_lam"] = torch.zeros(R, V, 4, 4, dtype=f, device=state.pos.device)
    return h


def least_seconds(nbytes_: int, ops: float) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def slot_work(state, params, sdf) -> dict:
    """{operation: (bytes, operations)} of one internal and one variable
    slot at `state` (the new beliefs' guard taken from the state's own)."""
    h = slot_fields(state, params)
    valid = belief_validity(state.belief_lam)
    n_gated = int((h["gate"] > 0).sum())
    V = params.n_vars
    flags = {"dynamic": params.dynamic_enabled, "obstacle": params.obstacle_enabled,
             "tracking": params.tracking_enabled}
    world = (params.world_width, params.world_height)
    internal = internal_slot_bytes(h, {n: h[n] for n in INTERNAL_OUT}, valid, sdf, world, flags)
    variable = variable_slot_bytes(h, {n: h[n] for n in VARIABLE_OUT}, valid)
    return {
        "internal_slot": (internal, OPS_PER_ITEM["internal_slot"] * n_gated * V),
        "variable_slot": (variable, OPS_PER_ITEM["variable_slot"] * n_gated * V),
    }

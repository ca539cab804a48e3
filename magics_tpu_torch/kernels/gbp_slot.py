"""One GBP slot of the whole swarm on the hot layout: the hand-written CUDA
kernels (csrc/gbp_slot.cu), their plain PyTorch versions, and the wrappers.

Counterpart of magics_tpu's kernels/gbp_slot.py (the Pallas kernels
`internal_slot` and `variable_slot`). The "hot layout" is the same: every
field is a [c..., P, R] plane stack with robots last, and the wrappers take
and return the same dicts of fields as the JAX functions, so the tests feed
both the same inputs.

* `internal_slot` — one internal slot: the obstacle factors' SDF taps,
  dynamic, obstacle and tracking factor messages, then the variable pass
  with snapshots and responses. The JAX kernel takes the taps as inputs
  (`obs_h0/hx/hy`, computed outside it because a TPU gather serialises); the
  port's kernel takes the SDF image and computes them itself.
  `internal_slot_reference` is the JAX-shaped plain version (taps in), held
  against the Pallas kernel; `internal_slot_fused_reference` is the plain
  version of the fused function (`obstacle_taps`, then the reference).
* `variable_slot` — the belief update of an external slot.

On a CUDA tensor each wrapper checks dtype, device, shape and contiguity,
allocates its outputs as views of one fresh buffer, launches the kernel and
adds one to its entry of `launch_counts`; it raises on anything the kernel
does not take. What a launch needs that depends only on the slot
parameters, R and the device (shapes, scalars, ctypes arrays) is built once
and cached. On a CPU tensor it runs the plain version. Nothing falls back
from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph import variables as VU
from magics_tpu_torch.kernels.build import current_stream


@dataclasses.dataclass(frozen=True)
class SlotParams:
    """Static parameters of the slot (hashable). The fields of magics_tpu's
    SlotParams but `rtol`, which neither slot reads: the cancellation-free
    dynamic messages need no negligible-message floor."""

    n_vars: int
    max_waypoints: int
    sigma_dynamics: float
    sigma_obstacle: float
    sigma_tracking: float
    obstacle_delta: float
    switch_padding: float
    attraction_distance: float
    dynamic_enabled: bool = True
    obstacle_enabled: bool = True
    tracking_enabled: bool = True


# input order for the internal slot (hot-layout tensors, R last)
_IN_FIELDS = (
    "gate",          # [1, R] f32: active & not_idle
    "tgate",         # [1, R] f32: gate & tracking iteration threshold
    "belief_eta",    # [4, V, R]
    "belief_lam",    # [4, 4, V, R]
    "belief_mean",   # [4, V, R]
    "prior_mean",    # [4, V, R]
    "prior_sigma",   # [V, R]
    "delta_t",       # [V-1, R]
    "dyn_v2f_eta",   # [2, 4, V-1, R]
    "dyn_v2f_lam",   # [2, 4, 4, V-1, R]
    "dyn_v2f_mu",    # [2, 4, V-1, R]
    "dyn_f2v_eta",   # [2, 4, V-1, R]
    "dyn_f2v_lam",   # [2, 4, 4, V-1, R]
    "obs_h0",        # [V-2, R]
    "obs_hx",        # [V-2, R]
    "obs_hy",        # [V-2, R]
    "obs_v2f_mu",    # [4, V-2, R]
    "obs_f2v_eta",   # [4, V-2, R]
    "obs_f2v_lam",   # [4, 4, V-2, R]
    "trk_v2f_mu",    # [4, V-2, R]
    "trk_f2v_eta",   # [4, V-2, R]
    "trk_f2v_lam",   # [4, 4, V-2, R]
    "trk_record",    # [V-2, R] i32
    "trk_timeout",   # [V-2, R] i32
    "trk_last_pos",  # [2, V-2, R]
    "trk_last_val",  # [V-2, R]
    "path_x",        # [W, R]
    "path_y",        # [W, R]
    "path_len",      # [1, R] i32
    "ext_sum_eta",   # [4, V, R] — sum over K of delivered external messages
    "ext_sum_lam",   # [4, 4, V, R]
)

#: the SDF taps of the JAX kernel's inputs, which the port's kernel computes
_TAP_FIELDS = ("obs_h0", "obs_hx", "obs_hy")

#: input order of the port's internal-slot kernel (csrc/gbp_slot.cu `In`)
_KERNEL_IN_FIELDS = tuple(n for n in _IN_FIELDS if n not in _TAP_FIELDS)

_OUT_FIELDS = (
    "belief_eta",
    "belief_lam",
    "belief_mean",
    "snap_eta",
    "snap_lam",
    "snap_mu",
    "dyn_v2f_eta",
    "dyn_v2f_lam",
    "dyn_v2f_mu",
    "dyn_f2v_eta",
    "dyn_f2v_lam",
    "obs_v2f_mu",
    "obs_f2v_eta",
    "obs_f2v_lam",
    "trk_v2f_mu",
    "trk_f2v_eta",
    "trk_f2v_lam",
    "trk_record",
    "trk_timeout",
    "trk_last_pos",
    "trk_last_val",
)

_VAR_IN_FIELDS = (
    "gate",          # [1, R] f32
    "belief_eta",    # [4, V, R] (old planes — kept where ~gate)
    "belief_lam",    # [4, 4, V, R]
    "belief_mean",   # [4, V, R] (old means — fallback where invalid)
    "prior_mean",    # [4, V, R]
    "prior_sigma",   # [V, R]
    "dyn_f2v_eta",   # [2, 4, V-1, R]
    "dyn_f2v_lam",   # [2, 4, 4, V-1, R]
    "obs_f2v_eta",   # [4, V-2, R]
    "obs_f2v_lam",   # [4, 4, V-2, R]
    "trk_f2v_eta",   # [4, V-2, R]
    "trk_f2v_lam",   # [4, 4, V-2, R]
    "ext_sum_eta",   # [4, V, R]
    "ext_sum_lam",   # [4, 4, V, R]
)

_VAR_OUT_FIELDS = ("belief_eta", "belief_lam", "belief_mean")

_INT_FIELDS = frozenset({"trk_record", "trk_timeout", "path_len"})

# What the slot kernels take, reckoned in plain Python from the sizes
# csrc/gbp_slot.cu uses (kMaxSmem, kMaxTile, the rows of InternalStaging and
# VariableStaging), so that no build is needed to ask: float32 only, V >= 3,
# and a tile of at least one robot whose staged inputs fit in a block's
# shared memory. The card tests hold `slot_tile` equal to the library's
# gbp_internal_tile / gbp_variable_tile.
KERNEL_DTYPE = torch.float32
_MAX_SMEM = 232448
_MAX_TILE = 8


def _staged_rows(kind: str, V: int) -> int:
    """Floats a robot stages in shared memory at V chain variables."""
    V1, V2 = V - 1, V - 2
    if kind == "internal":   # delta_t, dyn_v2f_eta, dyn_v2f_lam, obs_v2f_mu, prior, ext sums
        return V1 + 8 * V1 + 32 * V1 + 4 * V2 + 4 * V + V + 4 * V + 16 * V
    if kind == "variable":   # prior, ext sums, dyn / obs / trk f2v messages
        return 4 * V + V + 4 * V + 16 * V + 8 * V1 + 32 * V1 + 2 * (4 * V2 + 16 * V2)
    raise ValueError(f"unknown slot kernel {kind!r}")


def slot_tile(kind: str, V: int) -> int:
    """Robots per block of the "internal" or "variable" slot kernel at V:
    the largest power of two up to 8 whose staged inputs fit, 0 where no
    tile fits or V < 3."""
    if V < 3:
        return 0
    tile = _MAX_TILE
    while tile >= 1 and 4 * tile * _staged_rows(kind, V) > _MAX_SMEM:
        tile //= 2
    return tile


@functools.cache
def kernels_take(n_vars: int, dtype: torch.dtype) -> str | None:
    """None where both slot kernels take chains of `n_vars` variables of
    `dtype`, else the reason they do not (asked on every slot of a tick,
    hence cached)."""
    if dtype != KERNEL_DTYPE:
        return f"the slot kernels take {KERNEL_DTYPE}, not {dtype}"
    if n_vars < 3:
        return f"the slot kernels need V >= 3, got V={n_vars}"
    for kind in ("internal", "variable"):
        if slot_tile(kind, n_vars) == 0:
            return (f"the {kind} slot kernel's inputs at V={n_vars} do not fit in "
                    "shared memory")
    return None


#: kernel launches per wrapper since the last `reset_launch_counts()`
launch_counts = {"internal_slot": 0, "variable_slot": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def field_shapes(V: int, R: int, W: int) -> dict[str, tuple[int, ...]]:
    """The hot-layout shape of every slot field at V variables, R robots and
    W path points."""
    V1, V2 = V - 1, V - 2
    return {
        "gate": (1, R), "tgate": (1, R), "path_len": (1, R),
        "belief_eta": (4, V, R), "belief_lam": (4, 4, V, R), "belief_mean": (4, V, R),
        "snap_eta": (4, V, R), "snap_lam": (4, 4, V, R), "snap_mu": (4, V, R),
        "prior_mean": (4, V, R), "prior_sigma": (V, R), "delta_t": (V1, R),
        "dyn_v2f_eta": (2, 4, V1, R), "dyn_v2f_lam": (2, 4, 4, V1, R),
        "dyn_v2f_mu": (2, 4, V1, R), "dyn_f2v_eta": (2, 4, V1, R),
        "dyn_f2v_lam": (2, 4, 4, V1, R),
        "obs_h0": (V2, R), "obs_hx": (V2, R), "obs_hy": (V2, R),
        "obs_v2f_mu": (4, V2, R), "obs_f2v_eta": (4, V2, R), "obs_f2v_lam": (4, 4, V2, R),
        "trk_v2f_mu": (4, V2, R), "trk_f2v_eta": (4, V2, R), "trk_f2v_lam": (4, 4, V2, R),
        "trk_record": (V2, R), "trk_timeout": (V2, R), "trk_last_pos": (2, V2, R),
        "trk_last_val": (V2, R), "path_x": (W, R), "path_y": (W, R),
        "ext_sum_eta": (4, V, R), "ext_sum_lam": (4, 4, V, R),
    }


# --------------------------------------------------------------------------
# layout: hot [c..., P, R] <-> rows [R, P, c...]
# --------------------------------------------------------------------------

def rows(x: torch.Tensor) -> torch.Tensor:
    """Hot [c..., P, R] -> robot-major [R, P, c...] (a view)."""
    n = x.ndim
    return x.permute(n - 1, n - 2, *range(n - 2))


def hot(x: torch.Tensor) -> torch.Tensor:
    """Robot-major [R, P, c...] -> hot [c..., P, R], contiguous."""
    n = x.ndim
    return x.permute(*range(2, n), 1, 0).contiguous()


def component_axes(name: str) -> int:
    """How many trailing axes of a robot-major field are the components of
    one vector (1) or 4x4 matrix (2); the axes before them index robots,
    positions and factor slots."""
    if name.endswith("_lam"):
        return 2
    if name.endswith(("_eta", "_mean", "_mu", "_pos")) or name in ("ext_inbox", "ir_f2v_ext"):
        return 1
    return 0


#: a response is the belief less the incoming message, so its roundoff
#: scales with that message, which may be far larger than the response
RESPONSE_OPERAND = {"dyn_v2f_eta": "dyn_f2v_eta", "dyn_v2f_lam": "dyn_f2v_lam"}


def scaled_error(
    name: str, got: torch.Tensor, want: dict, hot_layout: bool = True
) -> float:
    """Largest error of field `name` of `got` against `want[name]` (hot
    layout, or robot-major with `hot_layout=False`), each vector or matrix
    over its own scale: max(|want| over its components, 1), and for a
    response also the incoming message's (RESPONSE_OPERAND). Scaling per
    (robot, position, slot) keeps the 1e30-pinned endpoint rows from setting
    the scale of every interior entry: those rows are held to their own
    relative error, the interior entries to theirs."""
    refs = [want[name]]
    if RESPONSE_OPERAND.get(name) in want:
        refs.append(want[RESPONSE_OPERAND[name]])
    if hot_layout:
        got, refs = rows(got), [rows(r) for r in refs]
    err = (got.double() - refs[0].double()).abs()
    scale = torch.stack([r.double().abs() for r in refs]).amax(dim=0)
    axes = tuple(range(err.ndim - component_axes(name), err.ndim))
    if axes:
        err, scale = err.amax(dim=axes), scale.amax(dim=axes)
    return float((err / scale.clamp(min=1.0)).max()) if err.numel() else 0.0


def _gate_rows(g: torch.Tensor) -> torch.Tensor:
    return g[0] > 0


def _select(gate: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(gate.reshape(gate.shape + (1,) * (new.ndim - 1)), new, old)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _variable_pass(h: dict, gate, dyn_eta, dyn_lam, int_eta, int_lam):
    """Belief update on robot-major tensors: prior + external sum + dynamic
    messages (slot 0 then slot 1) + the interior obstacle+tracking message,
    summed in the order the kernels add them, then the guarded inverse."""
    eta = rows(h["prior_sigma"])[..., None] * rows(h["prior_mean"]) + rows(h["ext_sum_eta"])
    eye = torch.eye(4, dtype=eta.dtype, device=eta.device)
    lam = rows(h["prior_sigma"])[..., None, None] * eye + rows(h["ext_sum_lam"])
    eta = eta + VU.pad_vars(dyn_eta[:, :, 0], 0, 1) + VU.pad_vars(dyn_eta[:, :, 1], 1, 0)
    lam = lam + VU.pad_vars(dyn_lam[:, :, 0], 0, 1) + VU.pad_vars(dyn_lam[:, :, 1], 1, 0)
    if int_eta.shape[1] > 0:
        eta = eta + VU.pad_vars(int_eta, 1, 1)
        lam = lam + VU.pad_vars(int_lam, 1, 1)
    upd = VU.update_beliefs(eta, lam, rows(h["belief_mean"]))
    return (
        _select(gate, upd.eta, rows(h["belief_eta"])),
        _select(gate, upd.lam, rows(h["belief_lam"])),
        _select(gate, upd.mean, rows(h["belief_mean"])),
    )


def internal_slot_reference(h: dict, p: SlotParams) -> dict:
    """The internal slot in plain PyTorch, on the same hot dict as the kernel:
    the port's factor functions and belief update on robot-major views."""
    f = h["belief_eta"].dtype
    V = p.n_vars
    gate = _gate_rows(h["gate"])
    tgate = _gate_rows(h["tgate"])

    dyn_eta, dyn_lam = rows(h["dyn_f2v_eta"]), rows(h["dyn_f2v_lam"])
    if p.dynamic_enabled:
        e, l = F.dynamic_factor_messages(
            rows(h["dyn_v2f_eta"]), rows(h["dyn_v2f_lam"]), rows(h["dyn_v2f_mu"]),
            rows(h["delta_t"]), p.sigma_dynamics, dtype=f,
        )
        dyn_eta, dyn_lam = _select(gate, e, dyn_eta), _select(gate, l, dyn_lam)

    obs_eta, obs_lam = rows(h["obs_f2v_eta"]), rows(h["obs_f2v_lam"])
    if p.obstacle_enabled and V > 2:
        e, l = F.obstacle_messages_from_taps(
            rows(h["obs_h0"]), rows(h["obs_hx"]), rows(h["obs_hy"]),
            rows(h["obs_v2f_mu"]), p.obstacle_delta, p.sigma_obstacle, dtype=f,
        )
        obs_eta, obs_lam = _select(gate, e, obs_eta), _select(gate, l, obs_lam)

    trk_eta, trk_lam = rows(h["trk_f2v_eta"]), rows(h["trk_f2v_lam"])
    record, timeout = rows(h["trk_record"]), rows(h["trk_timeout"])
    last_pos, last_val = rows(h["trk_last_pos"]), rows(h["trk_last_val"])
    if p.tracking_enabled and V > 2:
        path = torch.stack([rows(h["path_x"]), rows(h["path_y"])], dim=-1)  # [R, W, 2]
        plen = h["path_len"][0]
        e, l, new_rec, new_to, mp, h0, skipped = F.tracking_factor_messages(
            rows(h["trk_v2f_mu"]), path, plen, record, torch.zeros_like(plen), timeout,
            p.switch_padding, p.attraction_distance, p.sigma_tracking, dtype=f,
        )
        measured = tgate[:, None] & ~skipped
        trk_eta, trk_lam = _select(tgate, e, trk_eta), _select(tgate, l, trk_lam)
        record = _select(tgate, new_rec, record)
        timeout = _select(tgate, new_to, timeout)
        last_pos = torch.where(measured[..., None], mp, last_pos)
        last_val = torch.where(measured, h0, last_val)

    b_eta, b_lam, b_mean = _variable_pass(
        h, gate, dyn_eta, dyn_lam, obs_eta + trk_eta, obs_lam + trk_lam
    )

    out = {
        "belief_eta": b_eta, "belief_lam": b_lam, "belief_mean": b_mean,
        "snap_eta": b_eta, "snap_lam": b_lam, "snap_mu": b_mean,
        "dyn_v2f_eta": rows(h["dyn_v2f_eta"]), "dyn_v2f_lam": rows(h["dyn_v2f_lam"]),
        "dyn_v2f_mu": rows(h["dyn_v2f_mu"]),
        "dyn_f2v_eta": dyn_eta, "dyn_f2v_lam": dyn_lam,
        "obs_v2f_mu": rows(h["obs_v2f_mu"]), "obs_f2v_eta": obs_eta, "obs_f2v_lam": obs_lam,
        "trk_v2f_mu": rows(h["trk_v2f_mu"]), "trk_f2v_eta": trk_eta, "trk_f2v_lam": trk_lam,
        "trk_record": record, "trk_timeout": timeout,
        "trk_last_pos": last_pos, "trk_last_val": last_val,
    }
    if p.dynamic_enabled:
        # responses: dyn edge e slot 0 <- var e, slot 1 <- var e+1
        v_eta = torch.stack([b_eta[:, :-1], b_eta[:, 1:]], dim=2)
        v_lam = torch.stack([b_lam[:, :-1], b_lam[:, 1:]], dim=2)
        v_mu = torch.stack([b_mean[:, :-1], b_mean[:, 1:]], dim=2)
        out["dyn_v2f_eta"] = _select(gate, v_eta - dyn_eta, out["dyn_v2f_eta"])
        out["dyn_v2f_lam"] = _select(gate, v_lam - dyn_lam, out["dyn_v2f_lam"])
        out["dyn_v2f_mu"] = _select(gate, v_mu, out["dyn_v2f_mu"])
    interior_mean = b_mean[:, 1 : V - 1]
    if p.obstacle_enabled:
        out["obs_v2f_mu"] = _select(gate, interior_mean, out["obs_v2f_mu"])
    if p.tracking_enabled:
        out["trk_v2f_mu"] = _select(gate, interior_mean, out["trk_v2f_mu"])
    return {name: hot(x) for name, x in out.items()}


def internal_slot_fused_reference(
    h: dict, sdf: torch.Tensor, world: tuple[float, float], p: SlotParams
) -> dict:
    """The plain version of the port's fused internal slot: the SDF taps of
    the obstacle linearisation points (`factors.obstacle_taps`, the JAX
    "gather" method), then `internal_slot_reference`. `h` holds the kernel's
    fields (_KERNEL_IN_FIELDS), `sdf` the [H, W] image over a world of
    `world` (width, height) metres."""
    taps = F.obstacle_taps(
        h["obs_v2f_mu"].movedim(0, -1), sdf, world, dtype=h["belief_eta"].dtype
    )
    return internal_slot_reference({**h, **dict(zip(_TAP_FIELDS, taps))}, p)


def variable_slot_reference(h: dict, p: SlotParams) -> dict:
    """The external slot's belief update in plain PyTorch, on the hot dict."""
    b_eta, b_lam, b_mean = _variable_pass(
        h, _gate_rows(h["gate"]),
        rows(h["dyn_f2v_eta"]), rows(h["dyn_f2v_lam"]),
        rows(h["obs_f2v_eta"]) + rows(h["trk_f2v_eta"]),
        rows(h["obs_f2v_lam"]) + rows(h["trk_f2v_lam"]),
    )
    return {"belief_eta": hot(b_eta), "belief_lam": hot(b_lam), "belief_mean": hot(b_mean)}


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from magics_tpu_torch.kernels.build import load

        lib = load("gbp_slot")
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        floats = ctypes.POINTER(ctypes.c_float)
        ints = ctypes.POINTER(ctypes.c_int)
        c_int = ctypes.c_int
        lib.gbp_internal_slot.argtypes = [
            ptrs, ptrs, ctypes.c_void_p, c_int, c_int, c_int, c_int, c_int, floats, ints,
            ctypes.c_void_p,
        ]
        lib.gbp_internal_slot.restype = c_int
        for tile in (lib.gbp_internal_tile, lib.gbp_variable_tile):
            tile.argtypes = [c_int]
            tile.restype = c_int
        lib.gbp_variable_slot.argtypes = [
            ptrs, ptrs, c_int, c_int, floats, ints, ctypes.c_void_p
        ]
        lib.gbp_variable_slot.restype = c_int
        for fn in ("gbp_slot_in_fields", "gbp_slot_out_fields",
                   "gbp_variable_in_fields", "gbp_variable_out_fields"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = c_int
        counts = (
            lib.gbp_slot_in_fields(), lib.gbp_slot_out_fields(),
            lib.gbp_variable_in_fields(), lib.gbp_variable_out_fields(),
        )
        expected = (
            len(_KERNEL_IN_FIELDS), len(_OUT_FIELDS), len(_VAR_IN_FIELDS), len(_VAR_OUT_FIELDS)
        )
        if counts != expected:
            raise RuntimeError(f"kernel field counts {counts} != {expected}")
        _LIB = lib
    return _LIB


def _scalars(p: SlotParams):
    inv_s2 = 1.0 / (p.sigma_dynamics * p.sigma_dynamics)
    f = (
        12.0 * inv_s2, -6.0 * inv_s2, 4.0 * inv_s2,
        p.obstacle_delta, 1.0 / (p.sigma_obstacle * p.sigma_obstacle),
        1.0 / (p.sigma_tracking * p.sigma_tracking),
        p.switch_padding, p.switch_padding * 0.01, p.attraction_distance,
    )
    flags = (ctypes.c_int * 3)(
        int(p.dynamic_enabled), int(p.obstacle_enabled), int(p.tracking_enabled)
    )
    return f, flags


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _device_kind(h: dict) -> str:
    dev = h["gate"].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no slot kernel for device {dev}")
    return dev.type


class _Plan:
    """What a slot launch needs that depends only on the slot parameters, R
    and the device: the inputs' expected shapes and types, the outputs'
    places in one buffer, the float scalars and flags, and the ctypes
    argument arrays (filled anew at every call)."""

    def __init__(self, p: SlotParams, R: int, device, in_fields, out_fields, f_extra=()) -> None:
        V, W = p.n_vars, p.max_waypoints
        shapes = field_shapes(V, R, W)
        self.device = device
        self.stream_index = device.index if device.index is not None else 0
        self.R, self.V, self.W = R, V, W
        self.inputs = [
            (n, torch.Size(shapes[n]), torch.int32 if n in _INT_FIELDS else torch.float32)
            for n in in_fields
        ]
        # every output a contiguous slice of one float32 buffer, 256-byte
        # aligned (int fields are viewed as int32)
        self.outputs, offset = [], 0
        for n in out_fields:
            shape = torch.Size(shapes[n])
            self.outputs.append((n, shape, _contiguous(shape), offset, n in _INT_FIELDS))
            offset += -(-shape.numel() // 64) * 64
        self.numel = offset
        self.in_ptrs = (ctypes.c_void_p * len(in_fields))()
        self.out_ptrs = (ctypes.c_void_p * len(out_fields))()
        self.out_offsets = [4 * off for _, _, _, off, _ in self.outputs]
        f, self.flags = _scalars(p)
        self.f = (ctypes.c_float * (len(f) + len(f_extra)))(*f, *f_extra)

    def bind(self, h: dict) -> torch.Tensor:
        """Point the ctypes arrays at `h`'s inputs, after checking device,
        dtype, shape and contiguity (raises on anything the kernel does not
        take), and at a fresh output buffer, which it returns."""
        for j, (name, shape, dtype) in enumerate(self.inputs):
            x = h[name]
            if x.device != self.device:
                raise ValueError(f"{name} is on {x.device}, gate on {self.device}")
            if x.dtype != dtype:
                raise TypeError(f"{name} is {x.dtype}; the kernel takes {dtype}")
            if x.shape != shape:
                raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
            if not x.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
            self.in_ptrs[j] = x.data_ptr()
        buf = torch.empty(self.numel, dtype=torch.float32, device=self.device)
        base = buf.data_ptr()
        for j, off in enumerate(self.out_offsets):
            self.out_ptrs[j] = base + off
        return buf

    def views(self, buf: torch.Tensor) -> dict:
        """The outputs, as views of the buffer."""
        ibuf = buf.view(torch.int32)
        return {
            name: (ibuf if is_int else buf).as_strided(shape, stride, off)
            for name, shape, stride, off, is_int in self.outputs
        }


class _InternalPlan(_Plan):
    """The internal slot's plan, for one SDF shape and world size."""

    def __init__(self, p: SlotParams, R: int, sdf_shape, world, device) -> None:
        H, Ws = sdf_shape
        ww, wh = world
        self.sdf_shape = tuple(sdf_shape)
        # the taps' constants as obstacle_taps rounds them against float32
        taps = (ww / 2.0, wh / 2.0, Ws / ww, H / wh, F.obstacle_delta((H, Ws), world))
        super().__init__(p, R, device, _KERNEL_IN_FIELDS, _OUT_FIELDS, taps)

    def check_sdf(self, sdf: torch.Tensor) -> None:
        if sdf.device != self.device or sdf.dtype != torch.float32 or not sdf.is_contiguous():
            raise ValueError(
                f"the SDF must be a contiguous float32 tensor on {self.device}, "
                f"got {sdf.dtype} on {sdf.device}"
            )


def _contiguous(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


@functools.lru_cache(maxsize=64)
def _internal_plan(p: SlotParams, R: int, sdf_shape, world, device) -> _InternalPlan:
    if _lib().gbp_internal_tile(p.n_vars) == 0:
        raise ValueError(f"internal_slot: not even one robot's inputs at V={p.n_vars} fit "
                         "in shared memory")
    return _InternalPlan(p, R, sdf_shape, world, device)


@functools.lru_cache(maxsize=64)
def _variable_plan(p: SlotParams, R: int, device) -> _Plan:
    if _lib().gbp_variable_tile(p.n_vars) == 0:
        raise ValueError(f"variable_slot: not even one robot's inputs at V={p.n_vars} fit "
                         "in shared memory")
    return _Plan(p, R, device, _VAR_IN_FIELDS, _VAR_OUT_FIELDS)


def internal_slot(
    h: dict, sdf: torch.Tensor, world: tuple[float, float], p: SlotParams
) -> dict:
    """Run the internal slot: the CUDA kernel on CUDA tensors, the plain
    version (`internal_slot_fused_reference`) on CPU tensors. `h` maps
    _KERNEL_IN_FIELDS to hot-layout tensors (other keys are ignored), `sdf`
    is the [H, W] image over a world of `world` (width, height) metres;
    returns a dict of _OUT_FIELDS (fresh tensors)."""
    if _device_kind(h) == "cpu":
        return internal_slot_fused_reference(h, sdf, world, p)
    if p.n_vars < 3:
        raise ValueError(f"the slot kernel needs V >= 3, got {p.n_vars}")
    if sdf.ndim != 2:
        raise ValueError(f"the SDF must be [H, W], got shape {tuple(sdf.shape)}")
    gate = h["gate"]
    plan = _internal_plan(p, gate.shape[-1], tuple(sdf.shape), tuple(world), gate.device)
    buf = plan.bind(h)
    plan.check_sdf(sdf)
    H, Ws = plan.sdf_shape
    rc = _lib().gbp_internal_slot(
        plan.in_ptrs, plan.out_ptrs, sdf.data_ptr(), plan.R, plan.V, plan.W, H, Ws,
        plan.f, plan.flags, current_stream(plan.stream_index),
    )
    _check_launch(rc, "internal_slot")
    launch_counts["internal_slot"] += 1
    return plan.views(buf)


def variable_slot(h: dict, p: SlotParams) -> dict:
    """Run the external slot's belief update: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. `h` maps _VAR_IN_FIELDS to
    hot-layout tensors (other keys are ignored); returns a dict of
    _VAR_OUT_FIELDS (fresh tensors, views of one buffer)."""
    if _device_kind(h) == "cpu":
        return variable_slot_reference(h, p)
    if p.n_vars < 3:
        raise ValueError(f"the slot kernel needs V >= 3, got {p.n_vars}")
    gate = h["gate"]
    plan = _variable_plan(p, gate.shape[-1], gate.device)
    buf = plan.bind(h)
    rc = _lib().gbp_variable_slot(
        plan.in_ptrs, plan.out_ptrs, plan.R, plan.V, plan.f, plan.flags,
        current_stream(plan.stream_index),
    )
    _check_launch(rc, "variable_slot")
    launch_counts["variable_slot"] += 1
    return plan.views(buf)

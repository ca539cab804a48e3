"""The sender exchange's inter-robot message table: the hand-written CUDA
kernel (csrc/ir_slot.cu), its plain PyTorch version and the wrappers.

Counterpart of magics_tpu's kernels/ir_slot.py (the Pallas kernel
`interrobot_slot`); the sender exchange (graph/exchange.py) assembles its
inputs from a state (`exchange.sender_inputs`). For every
factor (robot r, neighbour slot k, chain position i) it computes the
compact rank-1 message (gx, gy, t, s) to the factor's external variable
from r's snapshot of variable i+1 (the cavity, where seeded), the external
variable's position as r holds it, the safety distance and a per-factor
tiny offset, where r's send gate and slot k's mask hold, and keeps the old
outbox's entry elsewhere. The plain version calls
`factors.interrobot_rank1_messages`, the port's one copy of that maths,
and selects with `torch.where`.

The kernel reads the state's own layout ([R, K, V-1] slot tables, the
[R, V, ...] snapshots) and writes [R, K, V-1, 4]; the plane transposes of
the JAX wrapper exist for the TPU's lanes and are not carried over. It
writes the new outbox whole, the select in the same launch.

On CUDA tensors `interrobot_slot` checks device, dtype, shape and
contiguity, allocates a fresh output, launches the kernel on the current
stream and adds one to `launch_counts`; it raises on anything the kernel
does not take and on a failed launch. On CPU tensors it runs the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.kernels.build import current_stream

#: kernel launches since the last `reset_launch_counts()`
launch_counts = {"interrobot_slot": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def interrobot_slot_reference(
    seeded: torch.Tensor,    # [R, K, V1] bool
    p_ext: torch.Tensor,     # [R, K, V1, 2]
    snap_mu: torch.Tensor,   # [R, V, 4]
    snap_eta: torch.Tensor,  # [R, V, 4]
    snap_lam: torch.Tensor,  # [R, V, 4, 4]
    safety: torch.Tensor,    # [R]
    gids: torch.Tensor,      # [R]
    sigma: float,
    old: torch.Tensor,       # [R, K, V1, 4]
    send_gate: torch.Tensor,  # [R] bool
    nbr_mask: torch.Tensor,  # [R, K] bool
) -> torch.Tensor:
    """The plain version (magics_tpu tick.py:external_factor_pass, the
    sender branch without Pallas): the internal cavity is the belief
    snapshot where the slot is seeded (empty elsewhere), and the tiny offset
    is fixed by slot position. Returns the new outbox [R, K, V1, 4]: the
    messages where `send_gate[r] & nbr_mask[r, k]` holds, `old` elsewhere."""
    R, K, V1 = seeded.shape
    f = snap_mu.dtype
    s3 = seeded[..., None]
    x_int = torch.where(s3, snap_mu[:, None, 1:], 0.0)
    cav_eta = torch.where(s3, snap_eta[:, None, 1:], 0.0)
    cav_lam = torch.where(s3[..., None], snap_lam[:, None, 1:], 0.0)
    # Per-factor tiny offset (interrobot.rs:75,91-106): besides guarding
    # div/0, distinct offsets break symmetric head-on deadlocks; derived from
    # the slot position so results do not depend on creation order.
    tiny = 1e-6 * (
        gids[:, None, None] * (K * V1)
        + torch.arange(K, dtype=f, device=gids.device)[None, :, None] * V1
        + torch.arange(V1, dtype=f, device=gids.device)[None, None, :]
        + 1.0
    )
    msg = F.interrobot_rank1_messages(
        x_int, p_ext, cav_eta, cav_lam, safety[:, None, None].expand(R, K, V1), tiny,
        sigma, dtype=f,
    )
    return torch.where((send_gate[:, None] & nbr_mask)[..., None, None], msg, old)


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from magics_tpu_torch.kernels.build import load

        lib = load("ir_slot")
        ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ir_interrobot_slot.argtypes = [ptr] * 11 + [c_int] * 3 + [c_float] * 3 + [ptr]
        lib.ir_interrobot_slot.restype = c_int
        _LIB = lib
    return _LIB


#: the kernel reads these in 8- or 16-byte words
_ALIGN = {"p_ext": 8, "snap_mu": 8, "snap_eta": 16, "snap_lam": 16, "old": 16}
_BOOL = ("seeded", "send_gate", "nbr_mask")


def _checked(inputs: dict) -> tuple[int, int, int]:
    """Check the kernel's inputs; returns (R, K, V)."""
    seeded = inputs["seeded"]
    R, K, V1 = seeded.shape
    V = V1 + 1
    shapes = {
        "seeded": (R, K, V1), "p_ext": (R, K, V1, 2), "snap_mu": (R, V, 4),
        "snap_eta": (R, V, 4), "snap_lam": (R, V, 4, 4), "safety": (R,), "gids": (R,),
        "old": (R, K, V1, 4), "send_gate": (R,), "nbr_mask": (R, K),
    }
    for name, want in shapes.items():
        x = inputs[name]
        dtype = torch.bool if name in _BOOL else torch.float32
        if x.device != seeded.device:
            raise ValueError(f"{name} is on {x.device}, seeded on {seeded.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes {dtype}")
        if tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if x.data_ptr() % _ALIGN.get(name, 1):
            raise ValueError(f"{name} is not {_ALIGN[name]}-byte aligned")
    return R, K, V


def interrobot_slot(
    seeded: torch.Tensor,
    p_ext: torch.Tensor,
    snap_mu: torch.Tensor,
    snap_eta: torch.Tensor,
    snap_lam: torch.Tensor,
    safety: torch.Tensor,
    gids: torch.Tensor,
    sigma: float,
    old: torch.Tensor,
    send_gate: torch.Tensor,
    nbr_mask: torch.Tensor,
) -> torch.Tensor:
    """The new outbox [R, K, V1, 4]: the CUDA kernel on CUDA tensors
    (float32), the plain version on CPU tensors. Arguments as for
    `interrobot_slot_reference`."""
    inputs = dict(seeded=seeded, p_ext=p_ext, snap_mu=snap_mu, snap_eta=snap_eta,
                  snap_lam=snap_lam, safety=safety, gids=gids, old=old, send_gate=send_gate,
                  nbr_mask=nbr_mask)
    if seeded.device.type == "cpu":
        return interrobot_slot_reference(**inputs, sigma=sigma)
    if seeded.device.type != "cuda":
        raise ValueError(f"no interrobot kernel for device {seeded.device}")
    R, K, V = _checked(inputs)
    out = torch.empty((R, K, V - 1, 4), dtype=torch.float32, device=seeded.device)
    if out.numel() == 0:
        return out
    # the constants as the plain version rounds them: a Python double,
    # rounded to float where it meets a float32 tensor
    alpha = 1.0 / (sigma * sigma)
    rtol = 1e-4
    rc = _lib().ir_interrobot_slot(
        *(x.data_ptr() for x in inputs.values()), out.data_ptr(), R, K, V, alpha,
        4.0 * alpha, rtol * alpha, current_stream(seeded.get_device()),
    )
    if rc != 0:
        raise RuntimeError(f"interrobot_slot kernel launch failed: cudaError {rc}")
    launch_counts["interrobot_slot"] += 1
    return out

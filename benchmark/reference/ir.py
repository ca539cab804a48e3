"""The plain versions of what the port's tick hands to its kernels outside
the GBP slots, frozen here: the one-address-space comm, the row gather
(K4's plain version) and the sender exchange's message table (K3's plain
version), copied from magics_tpu_torch/{parallel/comm.py,
kernels/layout.py, kernels/ir_slot.py}."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import factors as F


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """Single address space: tensors are already global."""

    def all_robots(self, arr: torch.Tensor) -> torch.Tensor:
        return arr

    def row_ids(self, n_local: int, device=None) -> torch.Tensor:
        return torch.arange(n_local, dtype=torch.int32, device=device)

    def row_offset(self) -> int:
        return 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def scatter_rows(self, arr: torch.Tensor) -> torch.Tensor:
        return arr

    def take_rows(self, arr: torch.Tensor, n_local: int) -> torch.Tensor:
        return arr


LOCAL = LocalComm()


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """`table.index_select(0, idx)`, zeroed where `mask` is false."""
    out = table.index_select(0, idx)
    if mask is not None:
        out = torch.where(mask[:, None], out, torch.zeros_like(out))
    return out


def sender_inputs(state, params, comm=LOCAL) -> dict:
    """The message table's inputs on the state's layout."""
    R = state.nbr_idx.shape[0]
    return dict(
        seeded=state.ir_int_seeded,
        p_ext=state.ir_v2f_ext_pos,
        snap_mu=state.snap_mu,
        snap_eta=state.snap_eta,
        snap_lam=state.snap_lam,
        safety=params.safety_distance_multiplier * state.radius,
        gids=comm.row_ids(R, state.device).to(state.prior_mean.dtype),
    )


def interrobot_slot_reference(seeded, p_ext, snap_mu, snap_eta, snap_lam, safety, gids,
                              sigma: float) -> torch.Tensor:
    """The sender's message table [R, K, V1, 4]: the internal cavity is the
    belief snapshot where the slot is seeded (empty elsewhere), and the tiny
    offset is fixed by slot position (interrobot.rs:75,91-106)."""
    R, K, V1 = seeded.shape
    f = snap_mu.dtype
    s3 = seeded[..., None]
    x_int = torch.where(s3, snap_mu[:, None, 1:], 0.0)
    cav_eta = torch.where(s3, snap_eta[:, None, 1:], 0.0)
    cav_lam = torch.where(s3[..., None], snap_lam[:, None, 1:], 0.0)
    tiny = 1e-6 * (
        gids[:, None, None] * (K * V1)
        + torch.arange(K, dtype=f, device=gids.device)[None, :, None] * V1
        + torch.arange(V1, dtype=f, device=gids.device)[None, None, :]
        + 1.0
    )
    return F.interrobot_rank1_messages(
        x_int, p_ext, cav_eta, cav_lam, safety[:, None, None].expand(R, K, V1), tiny,
        sigma, dtype=f,
    )

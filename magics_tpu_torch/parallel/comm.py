"""The communication backend of the tick (counterpart of magics_tpu's
parallel/comm.py).

Every cross-robot access in the tick goes through a `Comm`. Only the single
address-space backend exists so far: every robot-major tensor is already
global, gathers are plain indexing and reductions are no-ops. The
`torch.distributed` backend (ShardComm) is the multi-GPU item of ROADMAP
Queue 1.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """Single address space: tensors are already global."""

    def all_robots(self, arr: torch.Tensor) -> torch.Tensor:
        """Global view of a robot-major (leading axis = robots) tensor."""
        return arr

    def row_ids(self, n_local: int, device=None) -> torch.Tensor:
        """Global robot ids of the local rows."""
        return torch.arange(n_local, dtype=torch.int32, device=device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a (replicated-output) value over shards."""
        return x

    def scatter_rows(self, arr: torch.Tensor) -> torch.Tensor:
        """Reduce a per-global-robot partial sum across shards and keep the
        local rows. Local: identity."""
        return arr

    def take_rows(self, arr: torch.Tensor, n_local: int) -> torch.Tensor:
        """Slice the local rows out of a [R_total, ...] tensor."""
        return arr


LOCAL = LocalComm()

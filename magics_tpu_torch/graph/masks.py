"""Per-robot masks and clipped indexes, shared by the tick chain
(graph/tick.py), the GBP passes (graph/gbp.py) and the inter-robot exchange
(graph/exchange.py)."""

from __future__ import annotations

import torch


def expand_mask(mask: torch.Tensor, ndim_extra: int) -> torch.Tensor:
    """Expand a boolean mask with trailing singleton dims."""
    return mask.reshape(mask.shape + (1,) * ndim_extra)


def where_rows(gate_r: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-robot select between two [R, ...] tensors."""
    return torch.where(expand_mask(gate_r, new.ndim - 1), new, old)


def clip_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.clamp(0, n - 1).long()


def not_idle(state) -> torch.Tensor:
    """[R] robots on a mission or done with it (an Idle robot awaits its plan)."""
    return state.mission_active | state.completed

"""Batched variable belief update (counterpart of magics_tpu's
graph/variables.py): belief = prior + sum of inbox messages; covariance by a
guarded 4x4 inverse; the mean only moves where the inverse is valid."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from benchmark.reference.linalg import belief_covariance, mv
from benchmark.reference.factors import rank1_sum


class BeliefUpdate(NamedTuple):
    eta: torch.Tensor    # [R, V, 4]
    lam: torch.Tensor    # [R, V, 4, 4]
    mean: torch.Tensor   # [R, V, 4]
    valid: torch.Tensor  # [R, V]


def pad_vars(x: torch.Tensor, front: int, back: int) -> torch.Tensor:
    """Zero-pad axis 1 (the chain) of an [R, n, ...] tensor."""
    pad = [0, 0] * (x.ndim - 2) + [front, back]
    return Fn.pad(x, pad)


def sum_messages(
    *,
    prior_mean: torch.Tensor,     # [R, V, 4]
    prior_sigma: torch.Tensor,    # [R, V]
    dyn_f2v_eta: torch.Tensor,    # [R, V-1, 2, 4]
    dyn_f2v_lam: torch.Tensor,    # [R, V-1, 2, 4, 4]
    obs_f2v_eta: torch.Tensor,    # [R, V-2, 4]
    obs_f2v_lam: torch.Tensor,    # [R, V-2, 4, 4]
    trk_f2v_eta: torch.Tensor,    # [R, V-2, 4]
    trk_f2v_lam: torch.Tensor,    # [R, V-2, 4, 4]
    ext_inbox: torch.Tensor,      # [R, K, V-1, 4] compact rank-1 (gx, gy, t, s)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregate prior + all factor->variable messages per variable."""
    eye = torch.eye(4, dtype=prior_mean.dtype, device=prior_mean.device)
    eta = prior_sigma[..., None] * prior_mean
    lam = prior_sigma[..., None, None] * eye

    # dynamic factor e connects (var e, var e+1); slot 0 -> var e, slot 1 -> var e+1
    eta = eta + pad_vars(dyn_f2v_eta[:, :, 0], 0, 1) + pad_vars(dyn_f2v_eta[:, :, 1], 1, 0)
    lam = lam + pad_vars(dyn_f2v_lam[:, :, 0], 0, 1) + pad_vars(dyn_f2v_lam[:, :, 1], 1, 0)

    if obs_f2v_eta.shape[1] > 0:
        eta = eta + pad_vars(obs_f2v_eta, 1, 1) + pad_vars(trk_f2v_eta, 1, 1)
        lam = lam + pad_vars(obs_f2v_lam, 1, 1) + pad_vars(trk_f2v_lam, 1, 1)

    # external inter-robot factors: slot i covers var i+1
    ext_eta, ext_lam = rank1_sum(ext_inbox, dim=1)
    return eta + pad_vars(ext_eta, 1, 0), lam + pad_vars(ext_lam, 1, 0)


def update_beliefs(
    eta: torch.Tensor, lam: torch.Tensor, old_mean: torch.Tensor
) -> BeliefUpdate:
    """Invert precision and update means where valid (variable.rs:276-297):
    valid = any precision entry > 1e-6 and the guarded inverse holds."""
    precision_not_zero = (lam > 1e-6).any(dim=-1).any(dim=-1)
    cov, inv_ok = belief_covariance(lam)
    valid = precision_not_zero & inv_ok
    mean = torch.where(valid[..., None], mv(cov, eta), old_mean)
    return BeliefUpdate(eta=eta, lam=lam, mean=mean, valid=valid)

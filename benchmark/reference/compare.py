"""The comparisons that decide `correct`: the reference's own start against
the program's, and the reference stepped from a state the program handed
out against what the program produced from it. Plain PyTorch on the
reference's frozen tick; nothing of the program is imported."""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import linalg as RL
from benchmark.reference import tick as RT
from benchmark.reference.state import SimState


def as_reference(state) -> SimState:
    """The program's state as the reference's SimState (the same fields),
    on the same tensors: the reference's tick never writes its input."""
    return SimState(**{f.name: getattr(state, f.name) for f in dataclasses.fields(SimState)})


def follow(params, state, sdf, env_dist, ticks: int, tf32: bool = False) -> SimState:
    """`ticks` reference ticks from `state`; with `tf32` every matrix
    product rounds its operands to TF32 (the control)."""
    st = as_reference(state)
    if tf32:
        with RL.tf32_products():
            for _ in range(ticks):
                st = RT.step(st, sdf, params, env_dist)
    else:
        for _ in range(ticks):
            st = RT.step(st, sdf, params, env_dist)
    return st


def gap_quantiles(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The per-robot distances' median, 99th percentile and widest, m."""
    d = (got.double() - want.double().to(got.device)).norm(dim=-1).cpu()
    q = torch.quantile(d, torch.tensor([0.5, 0.99], dtype=torch.float64))
    return {"median": float(q[0]), "p99": float(q[1]), "max": float(d.max())}


def position_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest distance, in metres, between a robot's position in `got`
    and in `want` ([R, 2] each); a non-finite position in either reads
    infinite."""
    d = (got.double() - want.double()).norm(dim=-1)
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max()) if d.numel() else 0.0


def tf32_start(state) -> SimState:
    """The reference's start with every float field rounded to TF32: the
    control of the start's comparison."""
    return dataclasses.replace(as_reference(state), **{
        f.name: RL.to_tf32(getattr(state, f.name)) for f in dataclasses.fields(SimState)
        if getattr(state, f.name).is_floating_point()})


def start_gap(got, want) -> float:
    """How far the program's start lies from the reference's: the largest
    gap of a float field's entry over max(|reference entry|, 1), and 1 for
    any integer or boolean entry that differs, any shape or dtype that
    differs, or a NaN in one and not in the other."""
    worst = 0.0
    for f in dataclasses.fields(SimState):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.shape != b.shape or a.dtype != b.dtype:
            return 1.0
        if a.numel() == 0:
            continue
        if a.is_floating_point():
            a64, b64 = a.double(), b.double()
            if not torch.equal(torch.isnan(a64), torch.isnan(b64)):
                return 1.0
            both = ~torch.isnan(b64) & (a64 != b64)
            gap = ((a64 - b64).abs()[both] / b64.abs()[both].clamp(min=1.0)).nan_to_num(math.inf)
            if gap.numel():
                worst = max(worst, float(gap.max()))
        elif not torch.equal(a, b):
            return 1.0
    return worst

"""Run-time diagnostics time series (the RobotDiagnosticsPlugin equivalent).

The reference samples robot/variable/factor counts, message totals and
collision counts into Bevy Diagnostics at configurable rates and plots them in
the egui Metrics window (crates/magics/src/diagnostic/robot.rs:53-118,
ui/metrics.rs:36-101). Here the headless runner samples the same quantities
once per device chunk (one `torch.stack(...).cpu()`, one host sync per ~100
ticks instead of per frame) and the series lands in the JSON export under
"diagnostics" for offline plotting or the playback viewer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DiagnosticsRecorder:
    """Accumulates one row per sample; all fields are parallel lists."""

    n_vars: int

    time: list = dataclasses.field(default_factory=list)          # virtual s
    robots: list = dataclasses.field(default_factory=list)        # active
    completed: list = dataclasses.field(default_factory=list)
    variables: list = dataclasses.field(default_factory=list)     # live vars
    factors: list = dataclasses.field(default_factory=list)       # live factors
    external_factors: list = dataclasses.field(default_factory=list)
    msgs_sent_internal: list = dataclasses.field(default_factory=list)
    msgs_sent_external: list = dataclasses.field(default_factory=list)
    msgs_received_internal: list = dataclasses.field(default_factory=list)
    msgs_received_external: list = dataclasses.field(default_factory=list)
    rr_collisions: list = dataclasses.field(default_factory=list)
    re_collisions: list = dataclasses.field(default_factory=list)
    nbr_overflow: list = dataclasses.field(default_factory=list)

    def queue_row(self, state) -> torch.Tensor:
        """The diagnostic scalars of `state` as one tensor on its device,
        for `sample` to fetch (on the card queued, not waited for)."""
        V = self.n_vars
        msg = state.msg_counts.sum(dim=0)
        return torch.stack(
            [
                state.active.sum(),
                state.completed.sum(),
                state.nbr_mask.sum() * (V - 1),
                msg[0],
                msg[1],
                msg[2],
                msg[3],
                state.rr_collisions,
                state.re_collisions,
                state.nbr_overflow,
            ]
        )

    def sample(self, state, params, t: float, row: torch.Tensor | None = None) -> None:
        """Fetch the diagnostic scalars for one sample row (`row`, where the
        caller queued it with `queue_row`, else queued here).

        Factor counting mirrors diagnostic/robot.rs: per live robot V-1
        dynamic + (V-2) obstacle + (V-2) tracking factors, plus one
        inter-robot factor per active neighbour slot (each side owns its own
        factor, robot.rs:1441-1586).
        """
        V = self.n_vars
        # one fused fetch per sample
        row = (self.queue_row(state) if row is None else row).cpu().numpy()
        n_active_i = int(row[0])
        per_robot_internal = 0
        if params.dynamic_enabled:
            per_robot_internal += V - 1
        if params.obstacle_enabled:
            per_robot_internal += max(V - 2, 0)
        if params.tracking_enabled:
            per_robot_internal += max(V - 2, 0)
        self.time.append(round(t, 6))
        self.robots.append(n_active_i)
        self.completed.append(int(row[1]))
        self.variables.append(n_active_i * V)
        self.factors.append(n_active_i * per_robot_internal + int(row[2]))
        self.external_factors.append(int(row[2]))
        self.msgs_sent_internal.append(int(row[3]))
        self.msgs_sent_external.append(int(row[4]))
        self.msgs_received_internal.append(int(row[5]))
        self.msgs_received_external.append(int(row[6]))
        self.rr_collisions.append(int(row[7]))
        self.re_collisions.append(int(row[8]))
        self.nbr_overflow.append(int(row[9]))

    def as_dict(self) -> dict:
        return {
            "time": self.time,
            "robots": self.robots,
            "completed": self.completed,
            "variables": self.variables,
            "factors": self.factors,
            "external_factors": self.external_factors,
            "messages": {
                "sent": {
                    "internal": self.msgs_sent_internal,
                    "external": self.msgs_sent_external,
                },
                "received": {
                    "internal": self.msgs_received_internal,
                    "external": self.msgs_received_external,
                },
            },
            "collisions": {
                "robots": self.rr_collisions,
                "environment": self.re_collisions,
            },
            # cumulative neighbour-slot overflow (0 = exact reference
            # connectivity; >0 = nearest-K truncation was active)
            "neighbour_overflow": self.nbr_overflow,
        }

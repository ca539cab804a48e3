"""Offline experiment metrics.

Same definitions as the reference's analysis scripts so results are directly
comparable: LDJ (scripts/ldj.py:17-55), distance travelled
(scripts/distance-travelled.py:30-37), makespan (export.rs:353-357).
"""

from __future__ import annotations

import numpy as np


def log_dimensionless_jerk(velocities: np.ndarray, timestamps: np.ndarray) -> float:
    """LDJ = -ln( (T^3 / v_max^2) * integral |jerk|^2 dt )."""
    velocities = np.asarray(velocities, dtype=float)
    timestamps = np.asarray(timestamps, dtype=float)
    assert velocities.ndim == 2 and velocities.shape[1] == 2
    t_start, t_final = timestamps[0], timestamps[-1]
    dt = float(np.mean(np.diff(timestamps)))
    vx, vy = velocities[:, 0], velocities[:, 1]
    ax = np.gradient(vx, dt)
    ay = np.gradient(vy, dt)
    jx = np.gradient(ax, dt)
    jy = np.gradient(ay, dt)
    squared_jerk = jx**2 + jy**2
    t = np.linspace(t_start, t_final, len(velocities))
    integral = _simpson(squared_jerk, t)
    v_max = float(np.max(np.sqrt(vx**2 + vy**2)))
    return float(-np.log((t_final - t_start) ** 3 / v_max**2 * integral))


def _simpson(y: np.ndarray, x: np.ndarray) -> float:
    """Composite Simpson's rule (scipy.integrate.simpson equivalent)."""
    n = len(y) - 1
    if n < 2:
        return float(np.trapezoid(y, x))
    total = 0.0
    h = np.diff(x)
    for i in range(0, n - 1, 2):
        h0, h1 = h[i], h[i + 1]
        total += (
            (h0 + h1)
            / 6.0
            * (
                (2.0 - h1 / h0) * y[i]
                + (h0 + h1) ** 2 / (h0 * h1) * y[i + 1]
                + (2.0 - h0 / h1) * y[i + 2]
            )
        )
    if n % 2 == 1:  # trailing interval
        total += 0.5 * (y[-1] + y[-2]) * h[-1]
    return float(total)


def distance_travelled(positions: np.ndarray) -> float:
    positions = np.asarray(positions, dtype=float)
    return float(np.sum(np.linalg.norm(np.diff(positions, axis=0), axis=1)))

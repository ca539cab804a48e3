"""RRT* global planner (the `gbp_global_planner` crate's role).

The reference spawns an async RRT* task per robot when a mission route needs
global planning (crates/magics/src/planner/robot.rs:562-812: Idle ->
spawn_pathfinding_task -> poll -> feed tracking factors + reset variables).
In the headless TPU build, formation spawns are pre-planned, so paths are
computed host-side at scenario build time — one `plan()` per route segment —
and handed to the dense state as the robot's waypoint list / tracking path.

Feasibility is a bilinear sample of the environment's exact euclidean
distance transform (a ball of `collision_radius` around the sample point must
be obstacle-free), the dense analogue of the reference's parry2d
`intersection_test` loop (crates/gbp_global_planner/src/lib.rs:155-178).

The compute kernel is native C++ (magics_tpu/native/rrtstar.cpp) with a
pure-numpy fallback that implements the identical algorithm.
"""

from __future__ import annotations

import ctypes

import numpy as np

from magics_tpu_torch.config.schema import RrtSection
from magics_tpu_torch.native import rrtstar_native


class GlobalPlanner:
    def __init__(
        self,
        env_dist: np.ndarray,  # [H, W] meters-to-nearest-obstacle
        world_size: tuple[float, float],
        rrt: RrtSection,
        *,
        max_path_points: int = 64,
        force_fallback: bool = False,
    ):
        self.env_dist = np.ascontiguousarray(env_dist, dtype=np.float32)
        self.world_size = world_size
        self.rrt = rrt
        self.max_path_points = max_path_points
        self._native = None if force_fallback else rrtstar_native()
        #: "native" (the C++ RRT*) or "numpy" (the fallback)
        self.backend = "numpy" if self._native is None else "native"

    def plan(self, start, goal, seed: int = 0) -> np.ndarray | None:
        """Plan start -> goal. Returns [N, 2] world-coordinate path including
        both endpoints, or None if no path was found (the reference's
        PathfindingError::ReachedMaxIterations)."""
        start = np.asarray(start, dtype=np.float32)[:2]
        goal = np.asarray(goal, dtype=np.float32)[:2]
        if self._native is not None:
            return self._plan_native(start, goal, seed)
        return self._plan_numpy(start, goal, seed)

    # ------------------------------------------------------------------

    def _plan_native(self, start, goal, seed) -> np.ndarray | None:
        H, W = self.env_dist.shape
        out = np.empty((self.max_path_points, 2), dtype=np.float32)
        r = self.rrt
        n = self._native(
            self.env_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            H,
            W,
            float(self.world_size[0]),
            float(self.world_size[1]),
            float(start[0]),
            float(start[1]),
            float(goal[0]),
            float(goal[1]),
            float(r.collision_radius),
            float(r.step_size),
            float(r.neighbourhood_radius),
            int(r.max_iterations),
            int(bool(r.smoothing_enabled)),
            int(r.smoothing_max_iterations),
            float(r.smoothing_step_size),
            seed & 0xFFFFFFFFFFFFFFFF,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.max_path_points,
        )
        if n <= 0:
            return None
        return out[:n].astype(np.float64)

    # ------------------------------------------------------------------
    # numpy fallback (same algorithm; no grid buckets — fine for small use)
    # ------------------------------------------------------------------

    def _feasible(self, pts: np.ndarray) -> np.ndarray:
        """Vectorised point feasibility (pts [..., 2])."""
        H, W = self.env_dist.shape
        ww, wh = self.world_size
        x, y = pts[..., 0], pts[..., 1]
        inside = (np.abs(x) <= ww / 2) & (np.abs(y) <= wh / 2)
        xf = np.clip((x + ww / 2) * (W / ww) - 0.5, 0, W - 1)
        yf = np.clip((-y + wh / 2) * (H / wh) - 0.5, 0, H - 1)
        x0 = xf.astype(np.int64)
        y0 = yf.astype(np.int64)
        x1 = np.minimum(x0 + 1, W - 1)
        y1 = np.minimum(y0 + 1, H - 1)
        fx, fy = xf - x0, yf - y0
        d = (1 - fy) * (
            (1 - fx) * self.env_dist[y0, x0] + fx * self.env_dist[y0, x1]
        ) + fy * ((1 - fx) * self.env_dist[y1, x0] + fx * self.env_dist[y1, x1])
        return inside & (d > self.rrt.collision_radius)

    def _segment_feasible(self, a, b, interval) -> bool:
        n = int(np.linalg.norm(b - a) / interval) + 1
        t = (np.arange(1, n + 1) / n)[:, None]
        return bool(np.all(self._feasible(a[None, :] + t * (b - a)[None, :])))

    def _plan_numpy(self, start, goal, seed) -> np.ndarray | None:
        rng = np.random.default_rng(seed)
        r = self.rrt
        ww, wh = self.world_size
        if not (self._feasible(start[None])[0] and self._feasible(goal[None])[0]):
            return None
        check = r.step_size * 0.25
        xs = [start.astype(np.float64)]
        parents = [-1]
        costs = [0.0]
        pts = np.zeros((1, 2))
        pts[0] = start
        goal_idx = -1
        max_iters = min(int(r.max_iterations), 20000)  # fallback cap
        for _ in range(max_iters):
            s = rng.uniform([-ww / 2, -wh / 2], [ww / 2, wh / 2])
            d2 = np.sum((pts - s) ** 2, axis=1)
            near = int(np.argmin(d2))
            dvec = s - pts[near]
            dist = np.linalg.norm(dvec)
            if dist < 1e-9:
                continue
            new = pts[near] + dvec * min(1.0, r.step_size / dist)
            if not self._feasible(new[None])[0]:
                continue
            if not self._segment_feasible(pts[near], new, check):
                continue
            seg = np.linalg.norm(new - pts[near])
            nbr_d = np.linalg.norm(pts - new, axis=1)
            nbrs = np.nonzero(nbr_d <= r.neighbourhood_radius)[0]
            parent, best = near, costs[near] + seg
            for j in nbrs:
                c = costs[j] + nbr_d[j]
                if c < best and self._segment_feasible(pts[j], new, check):
                    parent, best = int(j), c
            xs.append(new)
            parents.append(parent)
            costs.append(best)
            pts = np.vstack([pts, new])
            new_id = len(xs) - 1
            for j in nbrs:
                c = best + nbr_d[j]
                if c < costs[j] and self._segment_feasible(new, pts[j], check):
                    parents[j] = new_id
                    costs[j] = c
            gd = np.linalg.norm(goal - new)
            if gd <= r.step_size and self._segment_feasible(new, goal.astype(np.float64), check):
                xs.append(goal.astype(np.float64))
                parents.append(new_id)
                costs.append(best + gd)
                goal_idx = len(xs) - 1
                break
        if goal_idx < 0:
            return None
        path = []
        i = goal_idx
        while i >= 0:
            path.append(xs[i])
            i = parents[i]
        path = np.array(path[::-1])
        if r.smoothing_enabled and len(path) > 2:
            interval = max(r.smoothing_step_size, 1e-6)
            for _ in range(int(r.smoothing_max_iterations)):
                if len(path) <= 2:
                    break
                i, j = sorted(rng.integers(0, len(path) - 1, size=2))
                if j - i < 2:
                    continue
                if self._segment_feasible(path[i], path[j], interval):
                    path = np.vstack([path[: i + 1], path[j:]])
        if len(path) > self.max_path_points:
            idx = np.linspace(0, len(path) - 1, self.max_path_points).astype(int)
            path = path[idx]
        return path

"""In-flight asynchronous global planning — the mission state machine.

The reference plans RRT* paths DURING the run on Bevy's async task pool
(crates/magics/src/planner/robot.rs:562-812): a robot spawns Idle, a
pathfinding task is submitted for its active route segment, the mission polls
it every FixedUpdate, and on arrival the path is fed into the tracking
factors, the variable chain is reset to a lerp towards the path
(factorgraph.rs:1541-1564 reset_variables), tracking factors get a 10-pass
timeout (factorgraph.rs:1565-1585, factor/tracking.rs:362-381), and the
mission turns Active. When a route segment completes, the next segment is
planned the same way (robot.rs:800-808).

Shape on the card (counterpart of magics_tpu's planner/mission.py):
planning runs host-side on a thread pool (the native C++ RRT*,
planner/global_planner.py) while the card advances in chunks. Idle robots
are device-resident but gated out of the GBP tick by `plan_pending`
(mission_active stays False — the reference's Idle mission skips iteration,
robot.rs:1795). Between chunks the host polls completed plans and applies
them to ALL arrived robots at once with one masked update (`apply_plans`,
plain torch ops on the state's device) — no per-robot work, no scatter.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.graph.exchange import EXCHANGES
from magics_tpu_torch.graph.masks import expand_mask


@dataclasses.dataclass
class _RobotMission:
    robot: int
    taskpoints: np.ndarray          # [T, 2] route taskpoints incl. start
    seg: int = 0                    # active route segment (taskpoints seg->seg+1)
    state: str = "idle"             # idle | waiting | active | done
    future: Future | None = None
    retries: int = 0


def _resample(path: np.ndarray, max_pts: int) -> np.ndarray:
    """Uniform arc-length resample keeping the endpoints (paths longer than
    the device waypoint capacity are re-described, never silently cut)."""
    if len(path) <= max_pts:
        return path
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    t = np.linspace(0.0, s[-1], max_pts)
    out = np.stack(
        [np.interp(t, s, path[:, 0]), np.interp(t, s, path[:, 1])], axis=1
    )
    out[0], out[-1] = path[0], path[-1]
    return out


class MissionManager:
    """Host half of the mission state machine for in-flight planned robots."""

    def __init__(
        self,
        params: GbpParams,
        planner_factory,
        *,
        seed: int = 0,
        max_workers: int = 4,
        max_retries: int = 3,
        deterministic: bool = True,
    ):
        self.params = params
        self._planner_factory = planner_factory
        self._planner = None
        self._pool: ThreadPoolExecutor | None = None
        self.missions: dict[int, _RobotMission] = {}
        self.rng = np.random.default_rng(seed)
        self.max_retries = max_retries
        self.max_workers = max_workers
        # deterministic=True blocks on an in-flight plan at the first poll
        # after it was requested, so a given seed always applies plans at the
        # same tick (planning still overlaps the device chunk in between).
        # False reproduces the reference's wall-clock-dependent polling
        # (robot.rs:643-648), which is NOT reproducible across runs.
        self.deterministic = deterministic

    def add_robot(self, robot: int, taskpoints: np.ndarray) -> None:
        self.missions[robot] = _RobotMission(robot, np.asarray(taskpoints, float))

    @property
    def active(self) -> bool:
        return any(m.state != "done" for m in self.missions.values())

    @property
    def pending(self) -> bool:
        """True while any robot still waits for a plan (callers shorten the
        device chunk so polls happen at near-tick granularity)."""
        return any(m.state in ("idle", "waiting") for m in self.missions.values())

    def _plan_async(self, m: _RobotMission) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.max_workers)
        if self._planner is None:
            self._planner = self._planner_factory()
        start = m.taskpoints[m.seg]
        goal = m.taskpoints[m.seg + 1]
        seed = int(self.rng.integers(2**62))
        m.future = self._pool.submit(self._planner.plan, start, goal, seed)
        m.state = "waiting"

    def poll(self, state: SimState, tick: int) -> SimState:
        """Advance every robot's mission; apply all arrived plans in one
        masked device update. Call between device chunks."""
        if not self.missions:
            return state

        completed = None  # fetched lazily (one host sync) only if needed
        spawn_ticks = state.spawn_tick.cpu().numpy()
        arrived: list[tuple[_RobotMission, np.ndarray]] = []
        for m in self.missions.values():
            if m.state == "done":
                continue
            if m.state == "active":
                if completed is None:
                    completed = state.completed.cpu().numpy()
                if completed[m.robot]:
                    if m.seg + 2 >= len(m.taskpoints):
                        m.state = "done"
                    else:
                        # route segment finished -> plan the next one
                        # (robot.rs:800-808 next_route -> Idle)
                        m.seg += 1
                        m.state = "idle"
            if m.state == "idle":
                spawn = int(spawn_ticks[m.robot])
                if spawn >= 0 and spawn <= tick:
                    self._plan_async(m)
            if m.state == "waiting" and m.future is not None and (
                self.deterministic or m.future.done()
            ):
                path = m.future.result()
                m.future = None
                if path is None:
                    m.retries += 1
                    if m.retries <= self.max_retries:
                        m.state = "idle"  # PathfindingError -> retry
                        continue
                    # terminal failure: go direct (straight segment)
                    path = np.stack([m.taskpoints[m.seg], m.taskpoints[m.seg + 1]])
                m.retries = 0
                m.state = "active"
                arrived.append((m, np.asarray(path, float)))

        if not arrived:
            return state

        R = state.n_robots
        W = state.waypoints.shape[1]
        V = state.n_vars
        p = self.params
        mask = np.zeros(R, bool)
        new_wps = np.zeros((R, W, 4))
        new_nwp = np.zeros(R, np.int32)
        new_path = np.zeros((R, W, 2))
        new_plen = np.zeros(R, np.int32)
        means = np.zeros((R, V, 4))
        for m, path in arrived:
            path = _resample(path, W)
            n = len(path)
            mask[m.robot] = True
            new_path[m.robot, :n] = path
            new_plen[m.robot] = n
            # waypoint state vectors: velocity points FORWARD at the next
            # point at target speed (spawner.rs:470-500 convention).
            # Deliberate divergence: the reference's mission-arrival path
            # computes dir = from - to (robot.rs:656), i.e. a backwards
            # velocity, which we treat as an upstream quirk — the spawner
            # convention is used for plan arrivals too (see docs parity notes).
            d = np.diff(path, axis=0)
            nrm = np.linalg.norm(d, axis=1, keepdims=True)
            vel = np.where(nrm > 0, d / np.maximum(nrm, 1e-30) * p.target_speed, 0.0)
            vel = np.concatenate([vel, vel[-1:]], axis=0)
            new_wps[m.robot, :n, :2] = path
            new_wps[m.robot, :n, 2:] = vel
            new_nwp[m.robot] = n
            # reset_variables means (robot.rs:739-765): lerp start -> next
            # with next = start + min(speed*horizon, 0.9*|dir|) dir_hat,
            # ratios i/n, velocity = speed * dir_hat everywhere
            start = path[0]
            dirv = path[1] - path[0]
            dlen = np.linalg.norm(dirv)
            dhat = dirv / dlen if dlen > 0 else np.zeros(2)
            s = min(p.target_speed * p.planning_horizon_seconds, 0.9 * dlen)
            nxt = start + s * dhat
            r = np.arange(V) / V
            means[m.robot, :, :2] = start[None] + r[:, None] * (nxt - start)[None]
            means[m.robot, :, 2:] = p.target_speed * dhat

        f = state.prior_mean.dtype

        def dev(x, dtype=None):
            return torch.as_tensor(x, device=state.device, dtype=dtype)

        return apply_plans(
            state,
            dev(mask),
            dev(new_wps, f),
            dev(new_nwp),
            dev(new_path, f),
            dev(new_plen),
            10,  # tracking timeout passes (factorgraph.rs:1584 set_timeout(10))
            dev(means, f),
            self.params.ext_exchange,
        )

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


def apply_plans(
    state: SimState,
    mask: torch.Tensor,       # [R] bool — robots whose plan arrived
    new_wps: torch.Tensor,    # [R, W, 4]
    new_nwp: torch.Tensor,    # [R] i32
    new_path: torch.Tensor,   # [R, W, 2]
    new_plen: torch.Tensor,   # [R] i32
    timeout: int,
    means: torch.Tensor,      # [R, V, 4] reset_variables means
    ext_exchange: str = "sender",
) -> SimState:
    """Apply arrived plans to the masked robots: route + tracking path swap,
    variable reset (reset_variables semantics: endpoint priors pinned at
    1e30, interior free; belief = prior), every factor inbox emptied, and
    tracking factors timed out for `timeout` passes."""
    f = state.prior_mean.dtype
    eye = torch.eye(4, dtype=f, device=state.device)
    sigma = state.prior_sigma  # [R, V] — pins are positional, unchanged
    belief_lam = sigma[..., None, None] * eye
    belief_eta = sigma[..., None] * means

    def zero_like(x):
        return torch.zeros_like(x)

    upd = dict(
        waypoints=new_wps,
        n_waypoints=new_nwp,
        target_idx=torch.ones_like(state.target_idx),
        trk_path=new_path,
        trk_path_len=new_plen,
        trk_index=torch.ones_like(state.trk_index),
        trk_record=zero_like(state.trk_record),
        trk_timeout=torch.full_like(state.trk_timeout, timeout),
        trk_last_val=zero_like(state.trk_last_val),
        prior_mean=means,
        belief_mean=means,
        belief_eta=belief_eta,
        belief_lam=belief_lam,
        snap_mu=means,
        snap_eta=belief_eta,
        snap_lam=belief_lam,
        # empty_inbox on every factor + variable reset (factorgraph.rs:1562)
        dyn_v2f_eta=zero_like(state.dyn_v2f_eta),
        dyn_v2f_lam=zero_like(state.dyn_v2f_lam),
        dyn_v2f_mu=zero_like(state.dyn_v2f_mu),
        dyn_f2v_eta=zero_like(state.dyn_f2v_eta),
        dyn_f2v_lam=zero_like(state.dyn_f2v_lam),
        obs_v2f_mu=zero_like(state.obs_v2f_mu),
        obs_f2v_eta=zero_like(state.obs_f2v_eta),
        obs_f2v_lam=zero_like(state.obs_f2v_lam),
        trk_v2f_mu=zero_like(state.trk_v2f_mu),
        trk_f2v_eta=zero_like(state.trk_f2v_eta),
        trk_f2v_lam=zero_like(state.trk_f2v_lam),
        ext_inbox=zero_like(state.ext_inbox),
        # Idle -> Active
        plan_pending=zero_like(state.plan_pending),
        mission_active=torch.ones_like(state.mission_active),
        completed=zero_like(state.completed),
        active=torch.ones_like(state.active),
    )
    out = {
        k: torch.where(expand_mask(mask, v.ndim - 1), v.to(getattr(state, k).dtype),
                       getattr(state, k))
        for k, v in upd.items()
    }
    # the inter-robot fields: the exchange's own reset (graph/exchange.py)
    out.update(EXCHANGES[ext_exchange].reset_arrived(state, mask))
    return dataclasses.replace(state, **out)

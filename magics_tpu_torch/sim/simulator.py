"""Headless scenario runner (counterpart of magics_tpu's sim/simulator.py).

Plays the role of the reference's Bevy app shell for experiments: loads a
scenario (config + environment + formations), pre-plans all robot spawns from
the formation timers (spawner.rs:223-323: first spawn after `delay`, then one
per `every`, `times` total), runs the dense tick in chunks, samples
positions/velocities at the tracker cadence (tracking.rs:48-110: every 100 ms),
and exports the reference's JSON schema (export.rs:250-350) so the shipped
analysis scripts (ldj.py, distance-travelled.py) work unchanged.

Construction is the JAX package's, call for call: the same numpy generator
draws the radii and placements in the same order, so one seed gives the same
`RobotSpec`s. The state is built on `device` (the card unless the caller
asks for the CPU). On the card `run` replays chunks of ticks captured as CUDA
graphs (graph/chunk.py:compile_ticks), one graph per chunk size as the JAX
package keeps one jit per size, at most two alive: `chunk_ticks`, and 5
while in-flight missions are active. A partial last chunk runs eagerly.
`advance(n)` (the REPL's and the live view's stepping) runs n ticks as
replays of the session's chunk graph and an eager remainder, so a new step
size captures no graph of its own.
Whatever changed the state outside a graph (a mission poll that applied
plans, `reset`, `resume`, an eager chunk, the other graph) is copied into
the graph's static state before its next replay (`TickGraph.load`); a live
edit of the params drops the graphs, which captured the old ones. On the CPU
`run` runs `tick.run_ticks` eagerly.

The comms-failure draws come from a `torch.Generator` on the state's device,
seeded from the scenario seed (ROADMAP F3): one seed gives bit-equal runs.

The shell's work is timed by the program's spans (profiling.py): `sim.build`,
`sim.reset`, `sim.export`, and in `advance` and `run` each step of a chunk
(`sim.chunk` around `sim.load`, `sim.replay` or `sim.eager`; `sim.wait`
for the card before the diagnostics fetch; `sim.own`, `sim.summary`, ...).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from magics_tpu_torch import profiling
from magics_tpu_torch.config.loader import Scenario
from magics_tpu_torch.env.sdf import distance_transform, env_to_image, env_to_sdf
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.graph.chunk import clone_state, compile_ticks
from magics_tpu_torch.graph.state import require_device
from magics_tpu_torch.io.diagnostics import DiagnosticsRecorder
from magics_tpu_torch.sim.builder import RobotSpec, build_scenario

#: the chunk size while in-flight missions are active: plans are polled
#: at near-tick granularity (the reference polls every FixedUpdate,
#: robot.rs:643-648)
MISSION_CHUNK_TICKS = 5

#: `run`'s chunk size when the caller names none
CHUNK_TICKS = 100


# GbpParams fields editable while a sim runs (the reference's live egui
# settings panel, ui/settings.rs). Params are captured in the chunk graphs,
# so a new value drops them and the next chunk captures anew. Shared by the
# REPL `set` command and the browser control channel of the JAX package.
LIVE_EDITABLE = {
    "comms_radius": float,
    "comms_failure_rate": float,
    "sigma_factor_dynamics": float,
    "sigma_factor_interrobot": float,
    "sigma_factor_obstacle": float,
    "sigma_factor_tracking": float,
    "safety_distance_multiplier": float,
    "dynamic_enabled": lambda v: str(v).lower() == "true",
    "interrobot_enabled": lambda v: str(v).lower() == "true",
    "obstacle_enabled": lambda v: str(v).lower() == "true",
    "tracking_enabled": lambda v: str(v).lower() == "true",
}


def apply_live_set(sim, key: str, value) -> str:
    """Apply one live config edit (`set key value`) to a running sim.

    Returns a human-readable confirmation; raises KeyError for a field
    that is not live-editable.
    """
    key = key.replace("-", "_")
    if key not in LIVE_EDITABLE:
        raise KeyError(
            f"not live-editable: {key} (editable: {', '.join(LIVE_EDITABLE)})"
        )
    sim.params = dataclasses.replace(sim.params, **{key: LIVE_EDITABLE[key](value)})
    return f"{key} = {getattr(sim.params, key)}"


@dataclasses.dataclass
class RobotLog:
    spawn_tick: int
    radius: float
    waypoints: np.ndarray          # [W, 4]
    positions: list                # [(t, x, y)]
    velocities: list = dataclasses.field(default_factory=list)  # [(t, vx, vy)]
    started_at: float = 0.0
    finished_at: float | None = None
    planning_strategy: str = "only-local"


@dataclasses.dataclass
class RunStats:
    """What `run` did on the card since the last `reset_stats()`: graphs
    captured (chunk size, seconds with the warm-up chunk), graph and eager
    chunks, and the loads of a state into a graph (each timed by CUDA
    events around the copy; `load_ms()` reads them)."""

    captures: list = dataclasses.field(default_factory=list)   # [(n, seconds)]
    graph_chunks: int = 0
    eager_chunks: int = 0
    max_graphs_alive: int = 0
    load_events: list = dataclasses.field(default_factory=list)

    @property
    def loads(self) -> int:
        return len(self.load_events)

    def load_ms(self) -> list[float]:
        """Device milliseconds of each load (synchronises with the card)."""
        if self.load_events:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.load_events]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class Simulator:
    @profiling.span("sim.build")
    def __init__(
        self,
        scenario: Scenario,
        *,
        seed: int | None = None,
        dtype: torch.dtype = torch.float32,
        n_slots: int | None = None,
        max_sim_time: float | None = None,
        viz_log: bool | None = None,
        inflight_planning: bool = True,
        device: torch.device | str = "cuda",
    ):
        """`inflight_planning`: rrt-star formations plan their route segments
        asynchronously DURING the run (the reference's mission state machine,
        robot.rs:562-812) — robots spawn Idle and activate when their plan
        arrives. False pre-plans every segment at build time instead
        (deterministic paths, no Idle phase). `device`: where the state
        lives, the card unless the caller asks for the CPU (without a card
        it raises)."""
        device = require_device(device)
        self.device = device
        self.scenario = scenario
        cfg = scenario.config
        self.cfg = cfg
        self.hz = cfg.simulation.hz
        self.dt = 1.0 / self.hz
        self.max_sim_time = max_sim_time or cfg.simulation.max_time
        seed = cfg.simulation.prng_seed if seed is None else seed
        self.seed = seed
        rng = np.random.default_rng(seed)

        env = scenario.environment
        world = env.world_size
        self._world = world
        self._planner = None
        # chunk size -> (TickGraph, the params it captured)
        self._graphs: dict[int, tuple] = {}
        self.stats = RunStats()
        sdf_np = env_to_sdf(env)
        # collision / planning geometry is unexpanded (map_generator.rs:22-38)
        obstacle_img = env_to_image(env, expansion=0.0) == 0
        mpp = world[0] / obstacle_img.shape[1]
        self.env_dist_np = distance_transform(obstacle_img, mpp)

        # ---- pre-plan spawns from formation timers ----
        specs: list[RobotSpec] = []
        self._spawn_groups: list[tuple[int, int]] = []  # (start_idx, count)
        max_ticks = int(self.max_sim_time * self.hz)
        speed = cfg.robot.target_speed
        for f in scenario.formations.formations:
            times = f.repeat_times if f.repeat_every_s else 1
            if times is None:  # infinite — bounded by max sim time
                times = max(1, int((self.max_sim_time - f.delay_s) // max(f.repeat_every_s, 1e-6)) + 1)
            for k in range(times):
                t_spawn = f.delay_s + k * (f.repeat_every_s or 0.0)
                tick = int(math.ceil(t_spawn * self.hz))
                if tick > max_ticks:
                    break
                radii = rng.uniform(cfg.robot.radius.min, cfg.robot.radius.max, f.robots)
                placed = f.as_positions(world, radii, rng)
                if placed is None:
                    continue
                initial, wp_lists = placed
                start_idx = len(specs)
                for i in range(f.robots):
                    wps_i = [w[i] for w in wp_lists]
                    taskpoints = None
                    inflight = False
                    if f.planning_strategy == "rrt-star":
                        taskpoints = np.stack(
                            [np.asarray(initial[i], dtype=np.float64)]
                            + [np.asarray(w, dtype=np.float64) for w in wps_i]
                        )
                        if inflight_planning:
                            # async mission flow (robot.rs:562-812): the
                            # waypoint list below is only the straight-chain
                            # fallback; MissionManager plans segments during
                            # the run and swaps in the real paths
                            inflight = True
                        else:
                            # pre-planned mode: plan every segment now
                            planner = self._global_planner()
                            planned = [taskpoints[0]]
                            for a, b in zip(taskpoints, taskpoints[1:]):
                                seg = planner.plan(a, b, seed=int(rng.integers(2**62)))
                                if seg is None:  # PathfindingError — go direct
                                    seg = np.stack([a, b])
                                planned.extend(list(seg[1:]))
                            wps_i = planned[1:]
                    # velocities (spawner.rs:470-500): each pose points at the
                    # next waypoint at target speed; last copies second-last
                    chain = [initial[i]] + wps_i
                    poses = []
                    for a, b in zip(chain, chain[1:] + [chain[-1]]):
                        d = np.asarray(b) - np.asarray(a)
                        n = np.linalg.norm(d)
                        v = d / n * speed if n > 0 else np.zeros(2)
                        poses.append(np.concatenate([a, v]))
                    if len(poses) >= 2:
                        poses[-1][2:] = poses[-2][2:]
                    wp_check = f.waypoint_reached
                    fin_check = f.finished
                    specs.append(
                        RobotSpec(
                            start=poses[0],
                            waypoints=np.stack(poses),
                            radius=float(radii[i]),
                            spawn_tick=tick,
                            wp_check_var=_check_var(wp_check),
                            fin_check_var=_check_var(fin_check),
                            wp_check_dist=wp_check.distance,
                            fin_check_dist=fin_check.distance,
                            planning_strategy=f.planning_strategy,
                            inflight=inflight,
                            taskpoints=taskpoints,
                        )
                    )
                self._spawn_groups.append((start_idx, f.robots))

        if not specs:
            # display-only scenarios exist (e.g. "Obstacle Shapes Showcase"
            # has `robots: 0` — it exercises the environment renderer only);
            # keep one inert padded slot so the dense state stays non-empty.
            specs = [
                RobotSpec(
                    start=np.zeros(4),
                    waypoints=np.zeros((2, 4)),
                    radius=cfg.robot.radius.min,
                    spawn_tick=-1,  # never activates
                )
            ]

        self.specs = specs

        # goal areas: the reference hardcodes two AABBs for the junction
        # scenarios (goal_area.rs:105-119); same here, keyed by scenario name
        goal_areas = None
        if "junction" in scenario.name.lower():
            goal_areas = np.array(
                [[-8.0, -52.0, 8.0, -48.0], [48.0, -8.0, 52.0, 8.0]]
            )
        self._goal_areas = goal_areas

        if n_slots is None:
            # The reference connects every in-range pair uncapped
            # (robot.rs:1441-1586). K = R-1 makes the slot tables exact for
            # any geometry at experiment scale; the 128 cap bounds memory for
            # large scenarios, where state.nbr_overflow reports any
            # truncation that actually occurs.
            n_slots = max(1, min(len(specs) - 1, 128))
        self.n_slots = n_slots

        sched = cfg.gbp.iteration_schedule
        self._build_kwargs = dict(
            target_speed=speed,
            planning_horizon=cfg.robot.planning_horizon,
            hz=self.hz,
            comms_radius=cfg.robot.communication.radius,
            comms_failure_rate=cfg.robot.communication.failure_rate,
            internal=sched.internal,
            external=sched.external,
            schedule=sched.schedule,
            lookahead_multiple=cfg.gbp.lookahead_multiple,
            n_slots=n_slots,
            sdf=sdf_np,
            world=world,
            dtype=dtype,
            device=device,
            sigma_factor_dynamics=cfg.gbp.sigma_factor_dynamics,
            sigma_factor_interrobot=cfg.gbp.sigma_factor_interrobot,
            sigma_factor_obstacle=cfg.gbp.sigma_factor_obstacle,
            sigma_factor_tracking=cfg.gbp.sigma_factor_tracking,
            tracking_switch_padding=cfg.gbp.tracking.switch_padding,
            tracking_attraction_distance=cfg.gbp.tracking.attraction_distance,
            dynamic_enabled=cfg.gbp.factors_enabled.dynamic,
            interrobot_enabled=cfg.gbp.factors_enabled.interrobot,
            obstacle_enabled=cfg.gbp.factors_enabled.obstacle,
            tracking_enabled=cfg.gbp.factors_enabled.tracking,
            despawn_on_final_waypoint=cfg.simulation.despawn_robot_when_final_waypoint_reached,
            safety_distance_multiplier=cfg.robot.inter_robot_safety_distance_multiplier,
            log_every=max(1, round(0.1 * self.hz)),  # 100 ms tracker cadence
            log_capacity=min(int(self.max_sim_time * self.hz), 10_000),
            # collision AABB recording materialises an [R^2, 7] scatter per
            # tick — keep it for experiment-scale runs, off for swarm scale
            collision_log_capacity=256 if len(specs) <= 256 else 0,
            # belief log for the playback viewer's predicted-trajectory /
            # uncertainty layers (visualiser/factorgraphs.rs, uncertainty.rs);
            # experiment scale only unless explicitly requested
            viz_log_capacity=(
                min(
                    int(self.max_sim_time * self.hz)
                    // max(1, round(0.1 * self.hz))
                    + 1,
                    2000,
                )
                if (viz_log if viz_log is not None else len(specs) <= 128)
                else 0
            ),
            goal_areas=goal_areas,
        )
        self.params, self.state, self.sdf = build_scenario(specs, **self._build_kwargs)
        self.env_dist = torch.as_tensor(self.env_dist_np, dtype=dtype, device=device)
        self.generator = torch.Generator(device=device).manual_seed(seed)

        self.mission = None
        if any(sp.inflight for sp in specs):
            self.mission = self._make_mission()

        self.diagnostics = DiagnosticsRecorder(n_vars=self.params.n_vars)

        self.logs = [
            RobotLog(
                spawn_tick=s.spawn_tick,
                radius=s.radius,
                waypoints=s.waypoints,
                positions=[],
                started_at=s.spawn_tick * self.dt,
                planning_strategy=s.planning_strategy,
            )
            for s in specs
        ]
        self._sample_interval_ticks = self.params.log_every

    # ------------------------------------------------------------------

    def _global_planner(self):
        if self._planner is None:
            from magics_tpu_torch.planner.global_planner import GlobalPlanner

            self._planner = GlobalPlanner(
                self.env_dist_np, self._world, self.cfg.rrt
            )
        return self._planner

    def _make_mission(self):
        from magics_tpu_torch.planner.mission import MissionManager

        mission = MissionManager(
            self.params, self._global_planner, seed=self.seed ^ 0x5EED
        )
        for i, sp in enumerate(self.specs):
            if sp.inflight:
                mission.add_robot(i, sp.taskpoints)
        return mission

    @profiling.span("sim.reset")
    def reset(self, seed: int | None = None) -> None:
        """Hot-reload the scenario (the F5 flow, simulation_loader.rs:687-713):
        despawn everything, reset virtual time, reseed the generator, rebuild
        the initial dense state. Params are unchanged (same scenario), so the
        captured chunks stay valid (the next replay loads the new state);
        host-side logs and diagnostics are cleared."""
        if seed is not None:
            self.seed = seed
        _, self.state, _ = build_scenario(self.specs, **self._build_kwargs)
        self.generator.manual_seed(self.seed)
        for rl in self.logs:
            rl.positions = []
            rl.velocities = []
            rl.finished_at = None
        self.diagnostics = DiagnosticsRecorder(n_vars=self.params.n_vars)
        if self.mission is not None:
            self.mission.shutdown()
            self.mission = self._make_mission()

    def save_settings(self, path=None) -> Path:
        """Persist the live Config back to the scenario's config.toml (the
        reference's save_settings, simulation_loader.rs:742-763)."""
        from magics_tpu_torch.config.schema import config_to_toml

        if path is None:
            if self.scenario.path is None:
                raise ValueError("scenario has no source directory; pass a path")
            path = Path(self.scenario.path) / "config.toml"
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(config_to_toml(self.cfg))
        return path

    def save_checkpoint(self, path) -> None:
        """Write the state, the comms-failure generator's state and host
        metadata (io/checkpoint.py, magics_tpu's format)."""
        from magics_tpu_torch.io import checkpoint as CK

        CK.save(path, self.state, params=self.params, generator=self.generator,
                meta={"scenario": self.scenario.name, "seed": self.seed})

    def resume(self, path) -> None:
        """Restore a checkpoint written by `save_checkpoint` (of either
        package) for the same scenario; the run continues deterministically
        from the saved tick (the generator too, where the checkpoint holds
        its state)."""
        from magics_tpu_torch.io import checkpoint as CK

        state, meta = CK.load(path, params=self.params, device=self.device,
                              generator=self.generator)
        if meta.get("scenario") not in (None, self.scenario.name):
            raise ValueError(
                f"checkpoint is for scenario {meta.get('scenario')!r}, "
                f"not {self.scenario.name!r}"
            )
        self.state = state

    # ------------------------------------------------------------------

    @property
    def graphs(self) -> dict:
        """The captured chunks alive, {ticks: TickGraph} (at most two)."""
        return {n: graph for n, (graph, _) in self._graphs.items()}

    def _chunk(self, state, n: int, graph_sizes: set):
        """n ticks from `state`: a replay of the graph of size n where n is
        one of `graph_sizes` (captured on first use, loaded with `state`
        where the state is not already the graph's own), else eagerly."""
        if self.device.type != "cuda" or n not in graph_sizes:
            self.stats.eager_chunks += 1
            with profiling.span("sim.eager"):
                return T.run_ticks(state, self.sdf, self.params, n, self.env_dist,
                                   generator=self.generator)
        entry = self._graphs.get(n)
        if entry is None:
            t0 = time.perf_counter()
            graph = compile_ticks(state, self.sdf, self.params, n, self.env_dist,
                                  generator=self.generator)
            self.stats.captures.append((n, time.perf_counter() - t0))
            self._graphs[n] = (graph, self.params)
            self.stats.max_graphs_alive = max(self.stats.max_graphs_alive, len(self._graphs))
        else:
            graph = entry[0]
            if state is not graph.state:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with profiling.span("sim.load"):
                    start.record()
                    graph.load(state)
                    end.record()
                self.stats.load_events.append((start, end))
        self.stats.graph_chunks += 1
        with profiling.span("sim.replay"):
            return graph.replay()

    def _keep_graphs(self, sizes: set) -> None:
        """Drop the graphs of other chunk sizes and those captured under
        other params (each holds a copy of the state)."""
        for n, (_, params) in list(self._graphs.items()):
            if n not in sizes or params != self.params:
                del self._graphs[n]

    def _owned(self, state):
        """`state` as the caller may keep it: a clone where any of its
        tensors is one of a graph's static state, which the graph's next
        replay overwrites (a mission poll's update keeps the fields it does
        not change)."""
        static = {id(x) for graph, _ in self._graphs.values() for x in vars(graph.state).values()}
        if any(id(x) in static for x in vars(state).values()):
            return clone_state(state)
        return state

    @profiling.span("sim.run")
    def run(
        self, max_ticks: int | None = None, progress=None, chunk_ticks: int = CHUNK_TICKS,
        checkpoint_path=None, checkpoint_every_s: float | None = None,
        on_chunk=None, harvest: bool = True,
    ) -> dict:
        """Run until every robot finished, or to tick `max_ticks` (the
        scenario's max time when None; 0 runs no tick).

        Positions are sampled on the device (tick.log_positions); the host
        fetches one row of diagnostics per chunk and the full log once at
        the end. `on_chunk(state, tick)` sees the state after each chunk,
        valid until the next chunk runs. `harvest=False` leaves the log on
        the device, for callers that run many short runs and harvest once
        when they end (`_harvest_log` rebuilds the series from the whole
        ring: its cost grows with the log, not with the ticks just run).
        """
        if max_ticks is None:
            max_ticks = int(self.max_sim_time * self.hz)
        state = self.state
        with profiling.span("sim.tick"):
            tick = int(state.tick)  # nonzero when resumed
        last_spawn = max(s.spawn_tick for s in self.specs)
        ckpt_interval = (
            int(checkpoint_every_s * self.hz) if checkpoint_every_s else None
        )
        last_ckpt = tick
        while tick < max_ticks:
            n = min(chunk_ticks, max_ticks - tick)
            sizes = {chunk_ticks}
            if self.mission is not None and self.mission.active:
                # in-flight plans resolve between chunks; poll at near-tick
                # granularity while any mission is unfinished (the reference
                # polls every FixedUpdate, robot.rs:643-648)
                n = min(n, MISSION_CHUNK_TICKS)
                sizes.add(MISSION_CHUNK_TICKS)
            with profiling.span("sim.keep"):
                self._keep_graphs(sizes)
            with profiling.span("sim.chunk"):
                state = self._chunk(state, n, sizes)
            tick += n
            if self.mission is not None:
                with profiling.span("sim.poll"):
                    state = self.mission.poll(state, tick)
            # the diagnostics row is queued behind the chunk, then the host
            # waits for the card, then fetches it
            with profiling.span("sim.sample"):
                row = self.diagnostics.queue_row(state)
            if state.pos.is_cuda:
                with profiling.span("sim.wait"):
                    torch.cuda.current_stream(state.pos.device).synchronize()
            with profiling.span("sim.sample"):
                self.diagnostics.sample(state, self.params, tick * self.dt, row=row)
            n_done = self.diagnostics.completed[-1]
            if progress is not None:
                progress(tick, n_done)
            if on_chunk is not None:
                # live-view hook: receives the device state
                with profiling.span("sim.on_chunk"):
                    on_chunk(state, tick)
            if (
                checkpoint_path is not None
                and ckpt_interval
                and tick - last_ckpt >= ckpt_interval
            ):
                with profiling.span("sim.checkpoint"):
                    self.state = self._owned(state)
                    self.save_checkpoint(checkpoint_path)
                last_ckpt = tick
            if (
                tick >= last_spawn
                and n_done == len(self.specs)
                and (self.mission is None or not self.mission.active)
            ):
                break

        with profiling.span("sim.own"):
            self.state = self._owned(state)
        state = self.state
        self.final_tick = tick
        if harvest:
            with profiling.span("sim.harvest"):
                self._harvest_log(state)
        with profiling.span("sim.summary"):
            return {
                "ticks": tick,
                "makespan": tick * self.dt,
                "completed": int(state.completed.sum()),
                "robots": len(self.specs),
                "rr_collisions": int(state.rr_collisions),
                "re_collisions": int(state.re_collisions),
                "nbr_overflow": int(state.nbr_overflow),
                "grid_overflow": int(state.grid_overflow),
            }

    @profiling.span("sim.advance")
    def advance(self, n: int, chunk_ticks: int = CHUNK_TICKS, progress=None,
                on_chunk=None) -> dict:
        """Run exactly n ticks, whether or not the robots have finished,
        as runs of at most `chunk_ticks`: whole chunks replay the session's
        graph of that size, the remainder runs eagerly. A step size of its
        own would cost a capture per distinct n (seconds each on the card).
        The log is not harvested; the caller harvests when it needs the
        series."""
        with profiling.span("sim.tick"):
            tick = int(self.state.tick)
        end = tick + n
        while True:
            summary = self.run(max_ticks=min(end, tick + chunk_ticks), chunk_ticks=chunk_ticks,
                               progress=progress, on_chunk=on_chunk, harvest=False)
            tick = summary["ticks"]
            if tick >= end:
                return summary

    def _harvest_log(self, state) -> None:
        """Unroll the on-device position/velocity ring buffers into per-robot
        series (the PositionTracker/VelocityTracker samples)."""
        head = int(state.log_head)
        log = _np(state.pos_log)  # [L, R, 2]
        vlog = _np(state.vel_log)
        L = log.shape[0]
        n = min(head, L)
        first = head - n  # sample index of the oldest retained row
        order = (first + np.arange(n)) % L
        sample_dt = self.params.log_every * self.dt
        finished_at = _np(state.finished_at)
        completed = _np(state.completed)
        for i, rl in enumerate(self.logs):
            rl.positions = []
            rl.velocities = []
            for m, row in enumerate(order):
                x, y = log[row, i]
                if not np.isnan(x):
                    t = (first + m) * sample_dt
                    rl.positions.append((t, float(x), float(y)))
                    vx, vy = vlog[row, i]
                    if not np.isnan(vx):
                        rl.velocities.append((t, float(vx), float(vy)))
            if completed[i] and finished_at[i] >= 0:
                rl.finished_at = float(finished_at[i])

    # ------------------------------------------------------------------

    @profiling.span("sim.export")
    def export(self, path: str | Path | None = None) -> dict:
        """JSON export matching export.rs:250-350 so the reference's analysis
        scripts run unchanged."""
        state = self.state
        rr = _np(state.rr_count)
        re = _np(state.re_count)
        msg = _np(state.msg_counts)
        robots = {}
        for i, log in enumerate(self.logs):
            positions = [[x, y] for (_, x, y) in log.positions]
            first_sample_at = log.positions[0][0] if log.positions else 0.0
            dt = self._sample_interval_ticks * self.dt
            velocities = [
                {
                    # bevy Vec3 layout: ground plane is [0] and [2]
                    "velocity": [vx, 0.0, vy],
                    "timestamp": t,
                    "measured_over": {"secs": int(dt), "nanos": int((dt % 1) * 1e9)},
                }
                for (t, vx, vy) in log.velocities
            ]
            finished = log.finished_at
            robots[str(i)] = {
                "radius": log.radius,
                # extra key (not in export.rs): anchors `positions` on the
                # time axis for offline playback; reference analysis scripts
                # ignore unknown keys
                "positions_start": first_sample_at,
                "positions": positions,
                "velocities": velocities,
                "collisions": {"robots": int(rr[i]), "environment": int(re[i])},
                "messages": {
                    "sent": {"internal": int(msg[i, 0]), "external": int(msg[i, 1])},
                    "received": {"internal": int(msg[i, 2]), "external": int(msg[i, 3])},
                },
                "mission": {
                    "waypoints": [[float(w[0]), float(w[1])] for w in log.waypoints],
                    "started_at": log.started_at,
                    "finished_at": finished if finished is not None else 0.0,
                    "duration": (finished - log.started_at)
                    if finished is not None
                    else self.final_tick * self.dt - log.started_at,
                },
                "planning_strategy": log.planning_strategy,
                "color": "",
            }

        # collision event records (export.rs:171-214)
        def _events(buf, count):
            n = min(int(count), buf.shape[0])
            return buf[:n]

        rr_ev = _events(_np(state.rr_events), _np(state.rr_event_count))
        re_ev = _events(_np(state.re_events), _np(state.re_event_count))
        coll_robots = [
            {
                "robot_a": int(e[0]),
                "robot_b": int(e[1]),
                "aabbs": [{"mins": [float(e[2]), float(e[3])],
                           "maxs": [float(e[4]), float(e[5])]}],
                "time": float(e[6]) * self.dt,  # extra key for playback
            }
            for e in rr_ev
        ]
        coll_env = [
            {
                "robot": int(e[0]),
                "obstacle": 0,
                "aabbs": [{"mins": [float(e[1]), float(e[2])],
                           "maxs": [float(e[3]), float(e[4])]}],
                "time": float(e[5]) * self.dt,  # extra key for playback
            }
            for e in re_ev
        ]

        # goal areas (goal_area.rs / export.rs:235-247)
        goal_areas = {}
        if self._goal_areas is not None:
            hist = _np(state.ga_history)
            for g, aabb in enumerate(self._goal_areas):
                goal_areas[str(g)] = {
                    "aabb": {"mins": [float(aabb[0]), float(aabb[1])],
                             "maxs": [float(aabb[2]), float(aabb[3])]},
                    "history": {
                        str(i): float(hist[g, i])
                        for i in range(hist.shape[1])
                        if hist[g, i] >= 0
                    },
                }

        from magics_tpu_torch.env.obstacles import export_obstacles

        sched = self.cfg.gbp.iteration_schedule
        data = {
            "scenario": self.scenario.name,
            "makespan": self.final_tick * self.dt,
            "delta_t": self.dt,
            # extra keys (not in export.rs) read by the playback viewer
            "sample_interval": self._sample_interval_ticks * self.dt,
            "world_size": list(self._world),
            "gbp": {"iterations": {"internal": sched.internal, "external": sched.external}},
            "robots": robots,
            "prng_seed": self.seed,
            "config": self.cfg.raw,
            "obstacles": export_obstacles(self.scenario.environment),
            "collisions": {"robots": coll_robots, "environment": coll_env},
            "goal_areas": goal_areas,
        }
        viz = self._harvest_viz(state)
        if viz is not None:
            data["viz"] = viz

        if self.diagnostics.time:
            # sampled time series (diagnostic/robot.rs / ui/metrics.rs)
            data["diagnostics"] = self.diagnostics.as_dict()

        if path is not None:
            Path(path).write_text(json.dumps(data))
        return data

    def _harvest_viz(self, state) -> dict | None:
        """Unroll the belief visualisation ring buffer (the playback viewer's
        predicted-trajectory and uncertainty layers; the live data of
        visualiser/factorgraphs.rs and uncertainty.rs)."""
        Lv = state.viz_mean.shape[0]
        if Lv == 0:
            return None
        head = int(state.log_head)
        n = min(head, Lv)
        if n == 0:
            return None
        first = head - n
        order = (first + np.arange(n)) % Lv
        sample_dt = self.params.log_every * self.dt

        def clean(a):  # NaN -> None, round for JSON size
            out = np.round(np.asarray(a, dtype=np.float64), 3)
            return [
                [
                    None
                    if np.isnan(rv).any()
                    else [float(x) for x in rv]
                    for rv in rr
                ]
                for rr in out
            ]

        mean = _np(state.viz_mean)[order]  # [n, R, V, 2]
        cov = _np(state.viz_cov)[order]    # [n, R, V, 3]
        trk = _np(state.viz_trk)[order]    # [n, R, V-2, 2]
        return {
            "t0": first * sample_dt,
            "dt": sample_dt,
            "mean": [clean(m) for m in mean],
            "cov": [clean(c) for c in cov],
            "tracking": [clean(t) for t in trk],
        }


def _check_var(check) -> int:
    iw = check.intersects_with
    if iw == "current":
        return 0
    if iw == "horizon":
        return -1
    if isinstance(iw, tuple) and iw[0] == "variable":
        return int(iw[1])
    return -1

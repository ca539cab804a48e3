"""The live view: `Simulator.advance` in chunks of `chunk_ticks`, each
followed by `LiveServer.push` of its frame (the server is not started), as
`LiveServer.drive` runs a live view. Episodes of `episode_ticks` ticks; after
each, `reset(next seed)`, timed in the window but outside every chunk.

Window: `tick_ms` is the window's seconds over all the ticks run in it;
`chunk_ms_p95` the 95th percentile of every chunk's time, from the call
that advances it to its frame on the host.

Check: in each episode two chunks, one drawn from the seed and the
episode's last, keep the state before them and after them and the pushed
frame. For the last `check_episodes` episodes of the window the reference
steps each such chunk from the state before it; the state after it and the
frame's positions are held to the reference's. The first episode's start
is held to the reference's own start, built from the configuration.
"""

from __future__ import annotations

import time

from benchmark import deploy, messages
from benchmark.harness import Check, Outcome, device_trace, log

#: a Simulator keeps the belief log for the player at up to this many robots
#: (its default, which the live view keeps)
VIZ_LOG_ROBOTS = 128


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def window_metrics(chunk_seconds: list, window_s: float, chunk_ticks: int) -> dict:
    """`tick_ms`: the whole window over every tick run in it (resets and
    pushes included); `chunk_ms_p95`: the 95th percentile over every chunk."""
    return {"tick_ms": 1e3 * window_s / (len(chunk_seconds) * chunk_ticks),
            "chunk_ms_p95": 1e3 * percentile(chunk_seconds, 95)}


def run(ctx) -> Outcome:
    import json

    import torch

    from benchmark.reference import compare, scenarios
    from magics_tpu_torch.graph.chunk import TickGraph, clone_state
    from magics_tpu_torch.io.diagnostics import DiagnosticsRecorder
    from magics_tpu_torch.planner.mission import MissionManager
    from magics_tpu_torch.sim.simulator import Simulator
    from magics_tpu_torch.viz.live import LiveServer

    cfg, traffic, data = ctx.cell.config, ctx.cell.traffic, ctx.cell.data
    chunk = traffic["chunk_ticks"]
    per_episode = traffic["episode_ticks"] // chunk
    sim = Simulator(deploy.circle_scenario(cfg, ctx.seed), seed=ctx.seed, device=ctx.device)
    server = LiveServer(sim)
    R = len(sim.specs)
    seeds = ctx.rng("episodes").integers(0, 2**31 - 1, size=100_000)
    picks = ctx.rng("check").integers(0, per_episode - 1, size=100_000)

    # warm-up: the chunk's graph is captured by the first advance
    sim.advance(chunk, chunk_ticks=chunk, on_chunk=lambda st, _t: server.push(st))
    sim.reset(int(seeds[0]))
    start = clone_state(sim.state)

    if ctx.trace:
        sync = ctx.sync
        ctx.wrap(DiagnosticsRecorder, "sample", "shell.sample", before=sync)
        ctx.wrap(TickGraph, "load", "shell.load", before=sync)
        ctx.wrap(LiveServer, "push", "shell.push", before=sync)
        ctx.wrap(MissionManager, "poll", "shell.poll", before=sync)
        ctx.wrap(Simulator, "reset", "episode.reset", before=sync)
    kept = []      # per episode: [(before, after, frame)]

    def hook(state, _tick):
        server.push(state)

    traces = []
    times = []
    episode = 0
    tracing = None
    t_end = ctx.open_window()
    t_start = time.perf_counter()
    stop = False
    while not stop:
        kept.append([])
        del kept[:-data["check_episodes"]]
        for c in range(per_episode):
            sampled = c in (int(picks[episode]), per_episode - 1)
            if sampled:
                before = clone_state(sim.state)
            if ctx.trace and len(times) == traffic["trace_from_chunk"]:
                tracing = device_trace(traces, ctx.spans)
                tracing.__enter__()
            t0 = time.perf_counter()
            sim.advance(chunk, chunk_ticks=chunk, on_chunk=hook)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if tracing is not None and len(times) == (traffic["trace_from_chunk"]
                                                      + traffic["trace_chunks"]):
                tracing.__exit__(None, None, None)
                tracing = None
            if sampled:
                # after the chunk's clock has stopped: `advance` leaves the
                # state it pushed in sim.state
                kept[-1].append((before, clone_state(sim.state),
                                 server.frames_since(0)[1][-1]))
            traced = not ctx.trace or len(times) >= (traffic["trace_from_chunk"]
                                                     + traffic["trace_chunks"])
            if t1 >= t_end and traced and any(kept):
                stop = True
                break
        else:
            episode += 1
            sim.reset(int(seeds[episode]))
    window_s = time.perf_counter() - t_start
    ticks = len(times) * chunk
    ctx.close_window()
    ctx.restore()
    log(f"[live] {len(times)} chunks of {chunk} ticks ({ticks} ticks, {episode + 1} episodes) "
        f"in {window_s:.3f} s; median chunk {1e3 * percentile(times, 50):.3f} ms")

    out = Outcome(
        attempted=len(times), failed=0,
        end_to_end=window_metrics(times, window_s, chunk),
        traces={"window": traces[0]} if traces else {},
        stats={"chunks": len(times), "ticks": ticks, "window_s": window_s,
               "shell_spans": {k: v for k, v in ctx.spans.total.items()
                               if k.startswith("shell.")}},
    )
    out.notes.append({"median_chunk_ms": 1e3 * percentile(times, 50),
                      **messages.line(sim.params, sim.state, out.end_to_end["tick_ms"])})
    if ctx.trace:
        graph = sim.graphs[chunk]
        replay = []
        with device_trace(replay):
            graph.replay()
        del graph
        out.traces["replay"] = replay[0]
        out.stats["replay_ticks"] = chunk

    # the check
    params, own_start, sdf, env_dist = scenarios.circle_experiment(
        cfg, R, ctx.seed, viz_log=R <= VIZ_LOG_ROBOTS, dtype=torch.float32,
        device=ctx.device)
    start_gap = compare.start_gap(start, own_start)
    control_start = (compare.start_gap(compare.tf32_start(own_start), own_start)
                     if ctx.control else None)
    checked = [pair for ep in kept for pair in ep]
    pos_gap = control_gap = 0.0 if checked else None
    del sim, server
    for before, after, frame in checked:
        ref = compare.follow(params, before, sdf, env_dist, chunk)
        shown = torch.tensor(json.loads(frame)["pos"], dtype=torch.float64)
        pos_gap = max(pos_gap, compare.position_gap(after.pos, ref.pos),
                      compare.position_gap(shown, ref.pos.cpu()))
        log(f"[live] chunk at tick {int(before.tick)}: program against the reference "
            f"{compare.gap_quantiles(after.pos, ref.pos)}")
        if ctx.control:
            control = compare.follow(params, before, sdf, env_dist, chunk, tf32=True)
            control_gap = max(control_gap, compare.position_gap(control.pos, ref.pos))
    log(f"[live] checked {len(checked)} chunks of the last {data['check_episodes']} episodes")
    limits = data["limits"]
    out.checks = [Check("start_gap", start_gap, limits["start_gap"]),
                  Check("pos_gap_m", pos_gap, limits["pos_gap_m"])]
    if ctx.control:
        out.control = [Check("start_gap", control_start, limits["start_gap"]),
                       Check("pos_gap_m", control_gap, limits["pos_gap_m"])]
    return out

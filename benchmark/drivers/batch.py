"""The swarm in batch: `compile_ticks` graphs of `chunk_ticks` ticks
replayed back to back, each followed by a synchronise and the fetch of one
diagnostics scalar (the overflow counters' sum). Every `episode_ticks`
ticks the graph is loaded with a device copy of the start, so the work per
tick is the same whatever the program's speed: the ring bunches as it
runs, and past ~230 ticks some of the seed's turns give a robot more than
K neighbours in range. A chunk after which a neighbour or a grid entry was
dropped counts as failed.

Window: `tick_ms` is the window's seconds over all the ticks run in it,
the loads included.

Check: in every episode the chunk drawn from the seed keeps the state
before it and after it. The reference steps the last episode's such chunk
from the state before it; the positions after it are held to the
reference's. The start is held to the reference's own, built from the
configuration.
"""

from __future__ import annotations

import time

from benchmark import deploy, messages
from benchmark.harness import Check, Outcome, device_trace, log


def run(ctx) -> Outcome:
    import torch

    from benchmark.reference import compare, scenarios
    from magics_tpu_torch.graph.chunk import clone_state, compile_ticks, copy_state_

    cfg, traffic, data = ctx.cell.config, ctx.cell.traffic, ctx.cell.data
    chunk = traffic["chunk_ticks"]
    per_episode = traffic["episode_ticks"] // chunk
    pick = int(ctx.rng("check").integers(0, per_episode))

    params, state, sdf = deploy.swarm_scenario(cfg, ctx.seed, device=ctx.device)
    start = clone_state(state)
    graph = compile_ticks(state, sdf, params, chunk)
    del state
    graph.replay()
    torch.cuda.synchronize()
    graph.load(start)
    before, after = clone_state(start), clone_state(start)
    kept = False

    if ctx.trace:
        ctx.wrap(graph, "load", "episode.load")
        ctx.wrap(graph, "replay", "chunk.replay")
    traces = []
    tracing = None
    chunks = overflow = overflowed = 0
    t_end = ctx.open_window()
    t0 = time.perf_counter()
    while True:
        c = chunks % per_episode
        if c == 0 and chunks:
            graph.load(start)
        if ctx.trace and chunks == traffic["trace_from_chunk"]:
            tracing = device_trace(traces, ctx.spans)
            tracing.__enter__()
        if c == pick:
            copy_state_(before, graph.state)
        graph.replay()
        if c == pick:
            copy_state_(after, graph.state)
            kept = True
        torch.cuda.synchronize()
        dropped = int(graph.state.nbr_overflow + graph.state.grid_overflow)
        overflow, overflowed = max(overflow, dropped), overflowed + (dropped > 0)
        chunks += 1
        if tracing is not None and chunks == traffic["trace_from_chunk"] + traffic["trace_chunks"]:
            tracing.__exit__(None, None, None)
            tracing = None
        traced = not ctx.trace or chunks >= traffic["trace_from_chunk"] + traffic["trace_chunks"]
        if time.perf_counter() >= t_end and traced and kept:
            break
    window_s = time.perf_counter() - t0
    ticks = chunks * chunk
    ctx.close_window()
    ctx.restore()
    log(f"[batch] {chunks} chunks of {chunk} ticks ({ticks} ticks) in {window_s:.3f} s; "
        f"overflow {overflow}")
    out = Outcome(
        attempted=chunks, failed=overflowed,
        end_to_end={"tick_ms": 1e3 * window_s / ticks},
        traces={"window": traces[0]} if traces else {},
        stats={"chunks": chunks, "ticks": ticks},
    )
    out.notes.append(messages.line(params, graph.state, out.end_to_end["tick_ms"]))
    if ctx.trace:
        from benchmark import rooflines

        out.stats["slot_work"] = rooflines.slot_work(graph.state, params, sdf)
        replay = []
        with device_trace(replay):
            graph.replay()
        out.traces["replay"] = replay[0]
        out.stats["replay_ticks"] = chunk
    del graph

    # the check
    ref_params, own_start, ref_sdf = scenarios.swarm(cfg, ctx.seed, dtype=torch.float32,
                                                     device=ctx.device)
    start_gap = compare.start_gap(start, own_start)
    control_start = (compare.start_gap(compare.tf32_start(own_start), own_start)
                     if ctx.control else None)
    del start, own_start
    ref = compare.follow(ref_params, before, ref_sdf, None, chunk)
    gaps = compare.gap_quantiles(after.pos, ref.pos)
    log(f"[batch] program against the reference: {gaps}")
    log(f"[batch] checked chunk {pick} of the last episode: {chunk} reference ticks")
    limits = data["limits"]
    out.checks = [Check("start_gap", start_gap, limits["start_gap"]),
                  Check("pos_gap_median_m", gaps["median"], limits["pos_gap_median_m"]),
                  Check("pos_gap_m", compare.position_gap(after.pos, ref.pos),
                        limits["pos_gap_m"])]
    if ctx.control:
        control = compare.follow(ref_params, before, ref_sdf, None, chunk, tf32=True)
        q = compare.gap_quantiles(control.pos, ref.pos)
        log(f"[batch] control against the reference: {q}")
        out.control = [Check("start_gap", control_start, limits["start_gap"]),
                       Check("pos_gap_median_m", q["median"], limits["pos_gap_median_m"]),
                       Check("pos_gap_m", compare.position_gap(control.pos, ref.pos),
                             limits["pos_gap_m"])]
    return out

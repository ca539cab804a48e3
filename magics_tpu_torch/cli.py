"""Headless CLI (counterpart of magics_tpu's cli.py) — parity with the
reference binary's experiment surface (crates/magics/src/cli.rs:28-104):

    python -m magics_tpu_torch.cli -i <scenario-name-or-path> [--scenarios-dir DIR]
    python -m magics_tpu_torch.cli --list-scenarios [--scenarios-dir DIR]

plus headless-specific knobs (--seed, --max-time, --export, --dtype). The
run is on the card unless `--platform cpu` asks for the CPU; without a card
it raises. A scenario directory's `environment.yaml` and `formation.yaml`
may be JSON documents, which need no PyYAML (`env.model.load_yaml`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def interactive_loop(sim, *, quiet: bool = False, live=None,
                     scenarios_dir=None, max_sim_time=None):
    """Pause/play + manual stepping REPL over a live simulation. Returns
    the final status and the Simulator the session ended on (a `load`
    replaces it), which `main` exports and checkpoints.

    Virtual time only advances on `step`/`run` — the paused prompt IS the
    reference's pause state (pause_play.rs:16-47); `step` is manual stepping
    (robot.rs:2448-2519, `manual-step-factor` granularity); `reset` is the
    F5 scenario-reload flow, `load NAME` the F4/F6 scenario-switch flow
    (simulation_loader.rs:594-720: despawn world, swap configs, reseed),
    built with the session's dtype and device. Commands act on the running
    device state, so exports/checkpoints snapshot mid-run. Stepping runs
    through `Simulator.advance`: whole chunks replay the session's graph, a
    remainder runs eagerly, so no step size captures a graph of its own.
    """

    def status() -> dict:
        st = sim.state
        tick = st.tick.item()
        return {
            "ticks": tick,
            "makespan": tick * sim.dt,
            "completed": int(st.completed.sum().item()),
            "robots": len(sim.specs),
            "rr_collisions": st.rr_collisions.item(),
            "re_collisions": st.re_collisions.item(),
            "nbr_overflow": st.nbr_overflow.item(),
        }

    def emit(msg):
        print(msg, file=sys.stderr, flush=True)

    def on_chunk(st, _tick):
        live.push(st)

    step_factor = max(1, int(sim.cfg.simulation.manual_step_factor))
    max_ticks = int(sim.max_sim_time * sim.hz)
    emit(
        "interactive: run [seconds] | step [n] | status | export PATH | "
        "checkpoint PATH | reset [seed] | quit"
    )
    while True:
        emit(f"[t={sim.state.tick.item() * sim.dt:.1f}s paused] > ")
        line = sys.stdin.readline()
        if not line:
            break
        parts = line.split()
        if not parts:
            continue
        cmd, rest = parts[0], parts[1:]
        hook = on_chunk if live is not None else None
        try:
            if cmd in ("q", "quit", "exit"):
                break
            elif cmd in ("s", "step"):
                sim.advance(int(rest[0]) if rest else step_factor, on_chunk=hook)
            elif cmd in ("r", "run"):
                tick = sim.state.tick.item()
                limit = (
                    tick + int(float(rest[0]) * sim.hz) if rest else max_ticks
                )
                sim.run(max_ticks=limit, on_chunk=hook, harvest=False)
            elif cmd == "status":
                emit(json.dumps(status()))
            elif cmd == "export" and rest:
                sim.final_tick = sim.state.tick.item()
                sim._harvest_log(sim.state)
                sim.export(rest[0])
                emit(f"exported to {rest[0]}")
            elif cmd == "checkpoint" and rest:
                sim.save_checkpoint(rest[0])
                emit(f"checkpoint: {rest[0]}")
            elif cmd == "save-settings":
                out = sim.save_settings(rest[0] if rest else None)
                emit(f"settings saved to {out}")
            elif cmd == "set" and len(rest) == 2:
                # live config editing with immediate effect (ui/settings.rs):
                # the chunk graphs captured the old params, so the next step
                # captures anew
                from magics_tpu_torch.sim.simulator import apply_live_set

                try:
                    emit(apply_live_set(sim, rest[0], rest[1]))
                except KeyError as ke:
                    emit(str(ke.args[0]))
            elif cmd == "snapshot" and rest:
                from magics_tpu_torch.env.sdf import env_to_image
                from magics_tpu_torch.viz.render import render_trajectories

                sim.final_tick = sim.state.tick.item()
                sim._harvest_log(sim.state)
                env = sim.scenario.environment
                render_trajectories(
                    sim.export(), rest[0], obstacle=env_to_image(env, expansion=0.0) == 0,
                    world=env.world_size,
                )
                emit(f"snapshot: {rest[0]}")
            elif cmd == "reset":
                sim.reset(seed=int(rest[0]) if rest else None)
                emit("scenario reloaded (F5)")
            elif cmd == "load" and rest and scenarios_dir is not None:
                # scenario SWITCH mid-session (the reference's F4/F6 +
                # Request::Load flow): drop the old world entirely, build
                # the new scenario, reseed from its own prng-seed
                from magics_tpu_torch.config.loader import load_scenario
                from magics_tpu_torch.sim.simulator import Simulator

                name = " ".join(rest)
                target = Path(name)
                if not target.is_dir():
                    target = Path(scenarios_dir) / name
                # carry the CLI --max-time override, the dtype and the
                # device across the switch: spec lists pre-materialize
                # repeated spawns out to max-time, so the scenario's own
                # 10,000 s default would build tens of thousands of specs
                # for repeating formations
                sim = Simulator(load_scenario(target), max_sim_time=max_sim_time,
                                dtype=sim.state.pos.dtype, device=sim.device)
                step_factor = max(1, int(sim.cfg.simulation.manual_step_factor))
                max_ticks = int(sim.max_sim_time * sim.hz)
                if live is not None:
                    live.rebind(sim)
                emit(f"loaded scenario: {sim.scenario.name}")
            elif cmd == "scenarios" and scenarios_dir is not None:
                from magics_tpu_torch.config.loader import list_scenarios

                emit("\n".join(list_scenarios(scenarios_dir)))
            elif cmd in ("h", "help"):
                emit(
                    "run [seconds] — advance virtual time (to max-time "
                    "without an argument); step [n] — advance n ticks "
                    f"(default {step_factor}); status; export PATH; "
                    "snapshot PATH.png; checkpoint PATH; set KEY VALUE "
                    "(live config edit); save-settings [PATH]; "
                    "reset [seed]; load NAME (switch scenario); "
                    "scenarios; quit"
                )
            else:
                emit(f"unknown command: {cmd} (try 'help')")
        except Exception as e:  # keep the session alive on bad input
            emit(f"error: {type(e).__name__}: {e}")

    sim.final_tick = sim.state.tick.item()
    sim._harvest_log(sim.state)
    return status(), sim


@contextlib.contextmanager
def _profiled(directory, device: torch.device):
    """torch.profiler over the run (the card's kernels too, on the card),
    its trace written to DIR/trace.json (chrome://tracing, Perfetto), with
    the program's spans as ranges beside the kernels."""
    from torch.profiler import ProfilerActivity, profile

    from magics_tpu_torch.profiling import annotate

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, annotate():
        yield
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


_ENVIRONMENTS = ["intersection", "intermediate", "complex", "circle", "maze", "test"]

# the FixedUpdate system chain (graph/tick.py:step; the reference's
# equivalent chain is robot.rs:86-108)
_SYSTEMS = [
    ("activate_due_spawns", "spawner timers"),
    ("check_waypoints", "reached_waypoint"),
    ("update_connectivity", "update_robot_neighbours +\\ndelete/create_interrobot_factors"),
    ("update_failed_comms", "Bernoulli antenna flips"),
    ("update_prior_horizon", "update_prior_of_horizon_state"),
    ("update_prior_current", "update_prior_of_current_state_v3"),
    ("iterate_gbp", "iterate_gbp_v2 (schedule)"),
    ("update_message_counts", "message counters"),
    ("update_collisions", "collision hysteresis"),
    ("update_goal_areas", "goal areas"),
    ("log_positions", "position/velocity/belief trackers"),
]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="magics-tpu-torch", description=__doc__)
    p.add_argument("-i", "--initial-scenario", help="scenario name or directory path")
    p.add_argument("-l", "--list-scenarios", action="store_true")
    p.add_argument(
        "--scenarios-dir",
        default="./config/scenarios",
        help="directory containing scenario folders (config.toml + *.yaml)",
    )
    p.add_argument(
        "--dump-default",
        choices=["config", "formation", "environment"],
        help="print the default schema document and exit (cli.rs:40-48)",
    )
    p.add_argument(
        "--dump-environment",
        choices=_ENVIRONMENTS,
        help="print a built-in environment preset as YAML (cli.rs:50-53; needs PyYAML)",
    )
    p.add_argument(
        "--dump-schedule",
        action="store_true",
        help="print the GBP iteration schedule table for the scenario",
    )
    p.add_argument(
        "--schedule-graph",
        action="store_true",
        help="print the FixedUpdate system chain as graphviz DOT and exit "
        "(main.rs:429-458 debugdump parity)",
    )
    p.add_argument("--seed", type=int, default=None, help="override prng-seed")
    p.add_argument("--max-time", type=float, default=None, help="override max sim time (s)")
    p.add_argument("--export", metavar="PATH", help="write JSON export here")
    p.add_argument(
        "--record",
        metavar="DIR",
        help="write a PNG frame sequence of the run (main.rs:460-565 parity)",
    )
    p.add_argument(
        "--snapshot",
        metavar="PNG",
        help="write a trajectory-overview image of the finished run",
    )
    p.add_argument(
        "--player",
        metavar="HTML",
        help="write an interactive playback viewer of the finished run "
        "(viz/player.py — the egui UI / visualiser-plugin equivalent)",
    )
    p.add_argument("--checkpoint", metavar="PATH", help="write checkpoints here")
    p.add_argument(
        "--checkpoint-every",
        type=float,
        metavar="SECONDS",
        help="periodic checkpoint interval in sim seconds",
    )
    p.add_argument("--resume", metavar="PATH", help="resume from a checkpoint")
    p.add_argument(
        "--save-settings",
        metavar="PATH",
        help="serialise the effective Config back to TOML "
        "(simulation_loader.rs:742-763 save_settings parity)",
    )
    p.add_argument("--dtype", choices=list(_DTYPES), default="f32")
    p.add_argument(
        "--platform",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the run goes: the card (the default; without one it "
        "raises) or the CPU",
    )
    p.add_argument(
        "--profile", metavar="DIR",
        help="trace the run with torch.profiler into DIR/trace.json (the "
        "reference's flamegraph/dhat profiles analog, Cargo.toml:149-152)",
    )
    p.add_argument(
        "--serve", type=int, nargs="?", const=8008, default=None,
        metavar="PORT",
        help="serve a live browser view of the running sim at "
             "http://localhost:PORT (viz/live.py — the headless redesign of "
             "the reference's live view, ui/mod.rs:36-83); composes with "
             "--interactive",
    )
    p.add_argument(
        "--interactive", action="store_true",
        help="drive the simulation from a REPL: pause/step/run virtual time "
        "(pause_play.rs:16-47, manual stepping robot.rs:2448-2519), reload "
        "(F5 flow), export/checkpoint mid-run",
    )
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="increase log verbosity (cli.rs:99-104 parity)",
    )
    p.add_argument(
        "--working-dir", metavar="DIR",
        help="chdir before doing anything else (cli.rs:95-97 parity)",
    )
    return p


def _environment_yaml(name: str) -> str:
    import dataclasses as dc

    import yaml

    from magics_tpu_torch.env.builtin import BUILTINS

    env = BUILTINS[name]()
    doc = {
        "tiles": {
            "grid": env.grid,
            "settings": {
                "tile-size": env.tile_size,
                "path-width": env.path_width,
                "obstacle-height": env.obstacle_height,
                "sdf": {
                    "resolution": env.sdf.resolution,
                    "expansion": env.sdf.expansion,
                    "blur": env.sdf.blur,
                },
            },
        },
        "obstacles": [
            {
                "shape": type(o.shape).__name__.lower(),
                "rotation": o.rotation,
                "translation": list(o.translation),
                "tile": list(o.tile),
                **dc.asdict(o.shape),
            }
            for o in env.obstacles
        ],
    }
    return yaml.safe_dump(doc, sort_keys=False, allow_unicode=True)


def session(argv=None):
    """`main`'s work: returns its exit code and the Simulator the run ended
    on (None where no scenario ran), for a caller that reads the sim."""
    p = _parser()
    args = p.parse_args(argv)

    if args.working_dir:
        import os

        os.chdir(args.working_dir)
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.DEBUG if args.verbose > 1 else logging.INFO
        )

    from magics_tpu_torch.config.loader import list_scenarios, load_scenario

    if args.dump_default:
        from magics_tpu_torch.config import dump

        print(
            {
                "config": dump.default_config_toml,
                "formation": dump.default_formation_yaml,
                "environment": dump.default_environment_yaml,
            }[args.dump_default]()
        )
        return 0, None

    if args.dump_environment:
        print(_environment_yaml(args.dump_environment))
        return 0, None

    if args.schedule_graph:
        print("digraph fixed_update {")
        print('  rankdir=LR; node [shape=box, fontname="monospace"];')
        for name, label in _SYSTEMS:
            print(f'  {name} [label="{name}\\n({label})"];')
        for (a, _), (b, _) in zip(_SYSTEMS, _SYSTEMS[1:]):
            print(f"  {a} -> {b};")
        print("}")
        return 0, None

    if args.list_scenarios:
        for name in list_scenarios(args.scenarios_dir):
            print(name)
        return 0, None

    if not args.initial_scenario:
        p.error("provide -i/--initial-scenario or --list-scenarios")

    path = Path(args.initial_scenario)
    if not path.is_dir():
        path = Path(args.scenarios_dir) / args.initial_scenario
    if not path.is_dir():
        print(f"error: scenario not found: {args.initial_scenario}", file=sys.stderr)
        return 2, None

    scenario = load_scenario(path)

    if args.dump_schedule:
        from magics_tpu_torch.core.schedule import schedule_booleans

        sched = scenario.config.gbp.iteration_schedule
        table = schedule_booleans(sched.schedule, sched.internal, sched.external)
        print(f"# {sched.schedule.value}: internal={sched.internal} external={sched.external}")
        print("slot internal external")
        for i, (a, b) in enumerate(table):
            print(f"{i:4d} {str(bool(a)).lower():8s} {str(bool(b)).lower()}")
        return 0, None

    from magics_tpu_torch.sim.simulator import Simulator

    sim = Simulator(
        scenario,
        seed=args.seed,
        dtype=_DTYPES[args.dtype],
        max_sim_time=args.max_time,
        device=args.platform,
    )
    if sim.device.type == "cuda":
        torch.cuda.set_device(sim.state.pos.device)
    if not args.quiet:
        print(
            f"scenario '{scenario.name}': {len(sim.specs)} robots, "
            f"V={sim.params.n_vars}, schedule "
            f"{scenario.config.gbp.iteration_schedule.internal}i+"
            f"{scenario.config.gbp.iteration_schedule.external}e @ {sim.hz} Hz "
            f"on {sim.device}",
            file=sys.stderr,
        )

    t0 = time.perf_counter()

    def progress(tick, n_done):
        if not args.quiet:
            print(
                f"  t={tick / sim.hz:7.1f}s  completed {n_done}/{len(sim.specs)}",
                file=sys.stderr,
            )

    if args.save_settings:
        out = sim.save_settings(args.save_settings)
        if not args.quiet:
            print(f"settings saved to {out}", file=sys.stderr)

    if args.resume:
        sim.resume(args.resume)
        if not args.quiet:
            print(f"resumed from {args.resume}", file=sys.stderr)

    profile_cm = (_profiled(args.profile, sim.device) if args.profile
                  else contextlib.nullcontext())
    live = None
    if args.serve is not None:
        from magics_tpu_torch.viz.live import LiveServer

        live = LiveServer(sim, port=args.serve)
        live.start()
        live.push(sim.state)
        if not args.quiet:
            print(f"live view: http://localhost:{live.port}", file=sys.stderr)
    try:
        with profile_cm:
            if args.interactive:
                summary, sim = interactive_loop(
                    sim, quiet=args.quiet, live=live,
                    scenarios_dir=args.scenarios_dir,
                    max_sim_time=args.max_time,
                )
                scenario = sim.scenario
            elif live is not None:
                # control-aware loop: the browser can pause/step/edit the run
                # (finer chunks -> smoother live frames, 0.5 s of sim each)
                summary = live.drive(
                    chunk_ticks=5, progress=progress,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every_s=args.checkpoint_every,
                )
            else:
                summary = sim.run(
                    progress=progress,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every_s=args.checkpoint_every,
                )
    finally:
        if live is not None:
            live.stop()
    if args.profile and not args.quiet:
        print(f"profile: {args.profile}", file=sys.stderr)
    summary["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(summary))

    if args.checkpoint:
        sim.save_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"checkpoint: {args.checkpoint}", file=sys.stderr)

    # one export for every output that reads it (the JAX CLI builds it once
    # for each: seconds a time with the viz log of an experiment)
    if args.export or args.player or args.record or args.snapshot:
        export = sim.export(args.export)
    if args.export and not args.quiet:
        print(f"exported to {args.export}", file=sys.stderr)

    if args.player:
        from magics_tpu_torch.viz.player import build_player

        Path(args.player).write_text(build_player(export))
        if not args.quiet:
            print(f"player: {args.player}", file=sys.stderr)

    if args.record or args.snapshot:
        from magics_tpu_torch.env.sdf import env_to_image
        from magics_tpu_torch.viz.render import record_frames, render_trajectories

        obstacle = env_to_image(scenario.environment, expansion=0.0) == 0
        world = scenario.environment.world_size
        if args.snapshot:
            render_trajectories(
                export, args.snapshot, obstacle=obstacle, world=world
            )
            if not args.quiet:
                print(f"snapshot: {args.snapshot}", file=sys.stderr)
        if args.record:
            n = record_frames(
                export, args.record, obstacle=obstacle, world=world,
                comms_radius=scenario.config.robot.communication.radius,
            )
            if not args.quiet:
                print(f"recorded {n} frames to {args.record}", file=sys.stderr)
    return 0, sim


def main(argv=None) -> int:
    return session(argv)[0]


if __name__ == "__main__":
    sys.exit(main())

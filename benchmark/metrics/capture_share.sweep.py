"""Share of the sweep rows' wall time spent capturing their chunk graphs,
as the program counts it (`Simulator.stats.captures`: the host clock
around `compile_ticks`, its eager warm-up chunk included), in %."""


def read(out):
    rows = out.stats.get("rows") or []
    wall = sum(r["wall_s"] for r in rows)
    if not wall:
        return None
    return 100.0 * sum(r["capture_s"] for r in rows) / wall

"""The GBP messages a tick sends, counted as the repo's bench.py counts
them (bench.py:96-116; copied from magics_tpu_torch/bench/headline.py):
per robot, an internal slot sends 2 x its internal factors' messages plus
K_active (V-1), an external slot 2 K_active (V-1)."""


def per_tick(params, n_robots: int, mean_degree: float) -> float:
    V = params.n_vars
    n_internal = sum(1 for i, _ in params.schedule if i)
    n_external = sum(1 for _, e in params.schedule if e)
    per_factor = 0
    if params.dynamic_enabled:
        per_factor += 2 * (V - 1)
    if params.obstacle_enabled:
        per_factor += V - 2
    if params.tracking_enabled:
        per_factor += V - 2
    internal = 2 * per_factor + mean_degree * (V - 1)
    external = 2 * mean_degree * (V - 1)
    return n_robots * (n_internal * internal + n_external * external)


def line(params, state, tick_ms: float) -> dict:
    """The message rate and the multiple of real time at `tick_ms`, the
    mean degree read from `state`."""
    R = state.pos.shape[0]
    degree = float(state.nbr_mask.sum()) / R
    ticks_per_s = 1e3 / tick_ms
    return {"gbp_message_updates_per_s": per_tick(params, R, degree) * ticks_per_s,
            "vs_baseline": ticks_per_s / params.hz, "mean_degree": degree, "robots": R}

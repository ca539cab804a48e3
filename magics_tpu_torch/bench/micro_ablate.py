"""Ablate individual tick systems by monkeypatching them to identity
(counterpart of the JAX package's bench/micro_ablate.py).

`tick.step` resolves its systems through the module's globals at call
time, and both GBP loops call `gbp.external_factor_pass` the same way, so
replacing one with a no-op removes exactly that system from the tick; the
time saved against the baseline is its cost in the whole tick (a
component timed alone misleads: what surrounds it changes).

    python -m magics_tpu_torch.bench.micro_ablate [R] [--variants=a,b,...] \\
        [--platform cuda|cpu] [--ticks N]

On the kernel path the external VARIABLE pass runs inside
graph/gbp.py:iterate_gbp_hot (K2 and the response delivery), not through
`gbp.external_variable_pass`, so "no_ext_var" runs on the plain passes
(`use_pallas=False`) and its saving is against "baseline_nopallas", as in
the JAX tool. Each variant runs as profile_tick.py times it: N-tick CUDA
graphs and eager chunks by CUDA events on the card, eager on the host
clock on the CPU.
"""

from __future__ import annotations

import sys

from magics_tpu_torch.bench.profile_tick import build, parse, time_variant


def _identity(state, *a, **k):
    return state


# each variant's systems, as (module, name): of graph/tick.py or graph/gbp.py
ABLATIONS = {
    "baseline": [],
    "baseline_nopallas": [],
    "no_ext_factor": [("gbp", "external_factor_pass")],
    "no_ext_var": [("gbp", "external_variable_pass")],
    "no_collisions": [("tick", "update_collisions"), ("tick", "update_collisions_grid")],
    "no_counts_log": [("tick", "update_message_counts"), ("tick", "log_positions")],
    "no_priors": [("tick", "update_prior_horizon"), ("tick", "update_prior_current")],
    "no_waypoints_goals": [("tick", "check_waypoints"), ("tick", "update_goal_areas")],
    "no_connectivity": [("tick", "update_connectivity"), ("tick", "update_connectivity_grid")],
}
NOPALLAS = {"no_ext_var", "baseline_nopallas"}


def main(argv=None) -> int:
    from magics_tpu_torch.graph import gbp, tick

    modules = {"gbp": gbp, "tick": tick}
    args = parse(argv, __doc__, ABLATIONS)
    results = {}
    for name in args.variants:
        params, state, sdf = build(args.robots, device=args.platform,
                                   use_pallas=False if name in NOPALLAS else None)
        saved = {(m, v): getattr(modules[m], v) for m, v in ABLATIONS[name]}
        try:
            for m, v in saved:
                setattr(modules[m], v, _identity)
            t = time_variant(name, params, state, sdf, args.ticks)
        finally:
            for (m, v), fn in saved.items():
                setattr(modules[m], v, fn)
        ms = t.get("graph_ms", t["eager_ms"])
        results[name] = ms
        base = results.get("baseline_nopallas" if name in NOPALLAS else "baseline")
        if base is not None and not name.startswith("baseline"):
            print(f"{'':28s} saves {base - ms:+.3f} ms/tick", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

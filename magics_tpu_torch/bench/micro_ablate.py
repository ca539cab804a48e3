"""Ablate individual tick systems by monkeypatching them to identity
(counterpart of the JAX package's bench/micro_ablate.py).

`tick.step` resolves its systems through the module's globals at call
time, and the hot-layout schedule calls `tick.external_factor_pass` the
same way, so replacing one with a no-op removes exactly that system from
the tick; the time saved against the baseline is its cost in the whole
tick (a component timed alone misleads: what surrounds it changes).

    python -m magics_tpu_torch.bench.micro_ablate [R] [--variants=a,b,...] \\
        [--platform cuda|cpu] [--ticks N]

On the kernel path the external VARIABLE pass runs inside
kernels/hot.py (K2 and the response delivery), not through the tick's
global, so "no_ext_var" runs on the plain passes (`use_pallas=False`) and
its saving is against "baseline_nopallas", as in the JAX tool. Each
variant runs as profile_tick.py times it: N-tick CUDA graphs and eager
chunks by CUDA events on the card, eager on the host clock on the CPU.
"""

from __future__ import annotations

import sys

from magics_tpu_torch.bench.profile_tick import build, parse, time_variant


def _identity(state, *a, **k):
    return state


ABLATIONS = {
    "baseline": [],
    "baseline_nopallas": [],
    "no_ext_factor": ["external_factor_pass"],
    "no_ext_var": ["external_variable_pass"],
    "no_collisions": ["update_collisions", "update_collisions_grid"],
    "no_counts_log": ["update_message_counts", "log_positions"],
    "no_priors": ["update_prior_horizon", "update_prior_current"],
    "no_waypoints_goals": ["check_waypoints", "update_goal_areas"],
    "no_connectivity": ["update_connectivity", "update_connectivity_grid"],
}
NOPALLAS = {"no_ext_var", "baseline_nopallas"}


def main(argv=None) -> int:
    from magics_tpu_torch.graph import tick as T

    args = parse(argv, __doc__, ABLATIONS)
    results = {}
    for name in args.variants:
        params, state, sdf = build(args.robots, device=args.platform,
                                   use_pallas=False if name in NOPALLAS else None)
        saved = {v: getattr(T, v) for v in ABLATIONS[name]}
        try:
            for v in saved:
                setattr(T, v, _identity)
            t = time_variant(name, params, state, sdf, args.ticks)
        finally:
            for v, fn in saved.items():
                setattr(T, v, fn)
        ms = t.get("graph_ms", t["eager_ms"])
        results[name] = ms
        base = results.get("baseline_nopallas" if name in NOPALLAS else "baseline")
        if base is not None and not name.startswith("baseline"):
            print(f"{'':28s} saves {base - ms:+.3f} ms/tick", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

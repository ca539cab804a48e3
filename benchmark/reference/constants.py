"""Framework-wide constants (the port's own copy of magics_tpu/core/constants.py).

Reference: crates/magics/src/factorgraph/mod.rs:14-20 — the state of every
variable is [x, y, xdot, ydot], so DOFS = 4.
"""

DOFS: int = 4

#: Prior precision (diagonal value) pinning the current & horizon variables.
#: Reference: crates/magics/src/planner/robot.rs:1198-1208 (sigma = 1e30 for
#: endpoint variables; interior variables get +inf which the variable ctor
#: zeroes out, crates/magics/src/factorgraph/variable.rs:146-149).
ENDPOINT_PRIOR_PRECISION: float = 1e30

#: Number of initial factor iterations during which tracking factors are
#: skipped. Reference: crates/magics/src/factorgraph/factorgraph.rs:701.
TRACKING_SKIP_FIRST_N_FACTOR_ITERS: int = 10

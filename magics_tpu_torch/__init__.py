"""magics_tpu_torch — the PyTorch + CUDA port of magics_tpu.

The same dense, batched Gaussian Belief Propagation planner for robot swarms
(`[R robots, V variables, ...]` tensors, one `graph/tick.py:step` per 10 Hz
FixedUpdate), written as plain functions on torch tensors with an explicit
device. Every Pallas kernel of the JAX package becomes a CUDA C++ kernel for
Hopper (`kernels/csrc/`), each with a plain PyTorch version beside it.

The module layout and function names follow `magics_tpu`, so the counterpart
of `magics_tpu/graph/tick.py` is `magics_tpu_torch/graph/tick.py`. The port
imports nothing of `magics_tpu`, not even its modules that import no
framework: it keeps its own copies (`core/constants.py`, `core/schedule.py`,
`core/timesteps.py`). No module of this package imports JAX.

Entry points (`sim.builder.build_scenario`, `graph.state.init_state`,
`convert.state_from_numpy`) build on the card unless the caller passes
`device="cpu"`, and raise where there is no card. On a CUDA state the GBP
slots run through the kernels unless `GbpParams.use_pallas` is False.
"""

__version__ = "0.1.0"

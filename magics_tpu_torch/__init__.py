"""magics_tpu_torch — the PyTorch + CUDA port of magics_tpu.

The same dense, batched Gaussian Belief Propagation planner for robot swarms
(`[R robots, V variables, ...]` tensors, one `graph/tick.py:step` per 10 Hz
FixedUpdate), written as plain functions on torch tensors with an explicit
device. The two fused Pallas slot kernels of the JAX package become CUDA C++
kernels for Hopper (`kernels/csrc/gbp_slot.cu`), each with a plain PyTorch
version beside it.

The module layout and function names follow `magics_tpu`, so the counterpart
of `magics_tpu/graph/tick.py` is `magics_tpu_torch/graph/tick.py`. Modules of
`magics_tpu` that import no framework (`core/constants.py`,
`core/schedule.py`, `core/timesteps.py`, `config/`, `env/`) are imported from
there rather than copied. No module of this package imports JAX.
"""

__version__ = "0.1.0"

"""The system's entry points outside the package proper, as modules
(counterparts of the JAX repo's scripts/): `run_experiment`, the experiment
sweep, and `parity_rmse`, the trajectory-parity harness against the
reference oracle. Run each with `python -m magics_tpu_torch.scripts.<name>`."""

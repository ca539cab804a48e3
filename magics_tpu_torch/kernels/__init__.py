"""The hand-written CUDA kernels (csrc/) and their wrappers. Each wrapper
module keeps its own `launch_counts`; these read and reset all of them."""


def launch_counts() -> dict[str, int]:
    """Every wrapper's kernel launches since its last reset."""
    from magics_tpu_torch.kernels import gbp_slot, ir_slot, layout

    return {**gbp_slot.launch_counts, **ir_slot.launch_counts, **layout.launch_counts}


def reset_launch_counts() -> None:
    from magics_tpu_torch.kernels import gbp_slot, ir_slot, layout

    for module in (gbp_slot, ir_slot, layout):
        module.reset_launch_counts()

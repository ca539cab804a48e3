"""The benchmark's frozen byte counts of the GBP slots equal chip_smoke.py's
(the counts reviewed with the kernels) on a small state on the CPU, a few
ticks into the swarm's run, with tracking on and off."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import deploy, rooflines  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


def small_swarm(tracking: bool):
    import torch

    from magics_tpu_torch.graph import tick as T

    torch.set_num_threads(2)
    cfg = json.loads((ROOT / "benchmark/configs/swarm-16384.json").read_text())
    cfg.update(robots=48, min_circle_radius=30.0, tracking_enabled=tracking)
    params, state, sdf = deploy.swarm_scenario(cfg, 987654321987, device="cpu")
    state = T.run_ticks(state, sdf, params, 3)
    return params, state, sdf


@pytest.mark.parametrize("tracking", [True, False])
def test_slot_bytes_equal_chip_smokes(smoke, tracking):
    import torch

    from magics_tpu_torch.kernels import gbp_slot as G
    from magics_tpu_torch.kernels import hot as HOT

    params, state, sdf = small_swarm(tracking)
    world = (params.world_width, params.world_height)
    sp = HOT.slot_params(params)
    h = smoke.slot_inputs(state, params)
    want = G.internal_slot_fused_reference(h, sdf, world, sp)
    valid = smoke.belief_validity(torch, want)
    flags = {"dynamic": params.dynamic_enabled, "obstacle": params.obstacle_enabled,
             "tracking": params.tracking_enabled}
    mine = rooflines.slot_fields(state, params)
    got = rooflines.internal_slot_bytes(
        mine, {n: G.rows(want[n]) for n in rooflines.INTERNAL_OUT}, valid, sdf, world, flags)
    assert got == smoke.internal_slot_bytes(torch, h, sdf, world, sp, want)

    var_in = {name: h[name] for name in G._VAR_IN_FIELDS}
    want = G.variable_slot_reference(var_in, sp)
    valid = smoke.belief_validity(torch, want)
    got = rooflines.variable_slot_bytes(
        mine, {n: G.rows(want[n]) for n in rooflines.VARIABLE_OUT}, valid)
    assert got == smoke.variable_slot_bytes(torch, var_in, want)


def test_slot_work_counts_operations_per_gated_robot_and_variable():
    params, state, sdf = small_swarm(True)
    work = rooflines.slot_work(state, params, sdf)
    n_gated = int((state.active & (state.mission_active | state.completed)).sum())
    assert work["internal_slot"][1] == 1640 * n_gated * params.n_vars
    assert work["variable_slot"][1] == 400 * n_gated * params.n_vars
    assert work["internal_slot"][0] > work["variable_slot"][0] > 0
    # a state with every robot gated off still writes every output
    off = dataclasses.replace(state, active=state.active & False)
    assert rooflines.slot_work(off, params, sdf)["internal_slot"][0] > 0

"""The port's CUDA slot kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (Hopper, sm_90a) and skips where
`torch.cuda.is_available()` is false; run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Inputs: a small converging crossing (R=37, so the robot edge is ragged
against the kernels' 16-robot tiles) after a few plain ticks, with SDF taps
from a non-trivial SDF; for tracking also a multi-segment corner route.
Tolerance: each vector or matrix of each field within RTOL of its own scale
(`gbp_slot.scaled_error`; float32 roundoff in another summation order,
chip_smoke.py states why).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from magics_tpu.core.schedule import ScheduleKind
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.kernels import gbp_slot as G
from magics_tpu_torch.kernels import hot as HOT
from magics_tpu_torch.sim.builder import build_scenario, circle_formation

pytestmark = pytest.mark.cuda

RTOL = 1e-4


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def make_slot_inputs(device):
    """Hot slot inputs of a 37-robot crossing after 12 plain ticks, and the
    slot parameters."""
    specs = circle_formation(37, circle_radius=30.0, target_speed=15.0)
    for i, s in enumerate(specs):
        s.start[:2] *= 1.0 + 0.01 * i
        s.waypoints[0, :2] *= 1.0 + 0.01 * i
    params, state, sdf = build_scenario(
        specs, target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
        internal=4, external=2, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=torch.float32,
        device=device, ext_exchange="receiver_compact",
    )
    state = T.run_ticks(state, sdf, params, 12)
    y, x = np.mgrid[0:64, 0:64] / 64
    sdf_obs = torch.as_tensor(
        np.round((0.5 + 0.5 * np.sin(9 * x) * np.cos(7 * y)) * 255) / 255,
        device=device, dtype=torch.float32,
    )
    world = (params.world_width, params.world_height)
    sp = replace(
        HOT.slot_params(params), obstacle_delta=F.obstacle_delta((64, 64), world)
    )
    h = HOT.to_hot(state, params)
    gate = (state.active & (state.mission_active | state.completed)).float()[None]
    gate[0, ::5] = 0.0  # some robots gated off
    taps = F.obstacle_taps(h["obs_v2f_mu"].movedim(0, -1), sdf_obs, world)
    ext = HOT._ext_sum_hot(state)
    slot_in = {
        **h, "gate": gate.contiguous(), "tgate": gate.contiguous(),
        "obs_h0": taps[0].contiguous(), "obs_hx": taps[1].contiguous(),
        "obs_hy": taps[2].contiguous(), "ext_sum_eta": ext[0], "ext_sum_lam": ext[1],
    }
    return slot_in, sp


@pytest.fixture(scope="module")
def slot_inputs(device):
    return make_slot_inputs(device)


# the final-approach geometry of tests/test_tracking_corner.py: a long
# segment into a corner, then a 3.3 m final segment, shorter than the
# switch padding of 5.0
CORNER_PATH = [(89.4, 52.56), (103.99, 52.25), (106.25, 49.875)]


def corner_route(slot_in: dict, sp, seed: int = 0):
    """The slot inputs moved onto a multi-segment corner route (W=4):
    tracking variables scattered around the corner, records -1..2 (so the
    previous-segment blend, the capped windows and record advance all run),
    some factors timed out, and some routes done (2 points) or degenerate
    (1 point)."""
    rng = np.random.default_rng(seed)
    dev = slot_in["gate"].device
    V2, R = slot_in["trk_record"].shape
    W = 4
    path = np.zeros((W, R, 2))
    path[:3] = np.asarray(CORNER_PATH)[:, None]
    plen = np.full(R, 3)
    plen[1::7], plen[2::7] = 2, 1
    xy = rng.uniform([88.0, 47.0], [108.0, 55.0], size=(V2, R, 2))
    mu = np.concatenate([xy, rng.normal(scale=3.0, size=(V2, R, 2))], axis=-1)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32, device=dev)

    h = {
        **slot_in,
        "path_x": f32(path[..., 0]), "path_y": f32(path[..., 1]),
        "path_len": i32(plen[None]),
        "trk_v2f_mu": f32(np.moveaxis(mu, -1, 0)),
        "trk_record": i32(rng.integers(-1, 3, size=(V2, R))),
        "trk_timeout": i32(rng.choice([-1, -1, -1, 0, 2], size=(V2, R))),
    }
    sp = replace(
        sp, max_waypoints=W, switch_padding=5.0, attraction_distance=2.0,
        tracking_enabled=True,
    )
    return h, sp


def _assert_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    errs = {}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == torch.int32:
            assert torch.equal(g, w), name
            continue
        assert bool(torch.isfinite(g).all()), name
        errs[name] = G.scaled_error(name, g, want)
    assert max(errs.values()) <= RTOL, errs


@pytest.mark.parametrize("tracking", [True, False])
def test_internal_slot_kernel_matches_plain(slot_inputs, tracking):
    slot_in, sp = slot_inputs
    sp = replace(sp, tracking_enabled=tracking)
    before = G.launch_counts["internal_slot"]
    got = G.internal_slot(slot_in, sp)
    torch.cuda.synchronize()
    assert G.launch_counts["internal_slot"] == before + 1
    _assert_close(got, G.internal_slot_reference(slot_in, sp))
    # outputs are fresh buffers, never the inputs
    assert all(got[n].data_ptr() != slot_in[n].data_ptr() for n in got)


def test_internal_slot_kernel_corner_route(slot_inputs):
    """Tracking on the corner route: the blend with the previous segment,
    the windows capped at half a segment, record advance and timeouts."""
    h, sp = corner_route(*slot_inputs)
    got = G.internal_slot(h, sp)
    torch.cuda.synchronize()
    want = G.internal_slot_reference(h, sp)
    _assert_close(got, want)
    assert bool((want["trk_record"] > h["trk_record"].clamp(min=0)).any())  # records advanced


def test_variable_slot_kernel_matches_plain(slot_inputs):
    slot_in, sp = slot_inputs
    var_in = {n: slot_in[n] for n in G._VAR_IN_FIELDS}
    before = G.launch_counts["variable_slot"]
    got = G.variable_slot(var_in, sp)
    torch.cuda.synchronize()
    assert G.launch_counts["variable_slot"] == before + 1
    _assert_close(got, G.variable_slot_reference(var_in, sp))


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(slot_inputs, fault):
    slot_in, sp = slot_inputs
    bad = dict(slot_in)
    x = bad["belief_lam"]
    bad["belief_lam"] = {
        "dtype": x.double(),
        "contiguity": x.transpose(0, 1),
        "shape": x[..., :-1],
    }[fault]
    before = G.launch_counts["internal_slot"]
    with pytest.raises((TypeError, ValueError)):
        G.internal_slot(bad, sp)
    assert G.launch_counts["internal_slot"] == before

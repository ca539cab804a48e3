"""The plain PyTorch versions of the slot kernels
(magics_tpu_torch/kernels/gbp_slot.py) against magics_tpu's Pallas slot
kernels, run in interpret mode under `jax.jit` at R=8 (r_tile=8), float32.

The hot dict is that of tests/test_pallas_slot.py (a 6-robot circle after the
pre-GBP systems, padded to 8 robots), with SDF taps from a non-trivial SDF
and the tracking gate forced open, so every factor kind produces messages.
The route is a single segment, where the Pallas kernel's tracking (which
lacks the corner fix, ROADMAP fault F1) and the port's agree; that fixture
already holds the Pallas kernel against the XLA path. Tolerances are those of
test_pallas_slot.py:86-100, each vector or matrix relative to its own scale.

The port's internal-slot kernel takes the SDF and samples the taps itself;
its plain version (`internal_slot_fused_reference`, what the wrapper runs on
the CPU) is held against JAX `obstacle_taps` plus the Pallas kernel, with
obstacle linearisation points on pixel edges and outside the image.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.env.builtin import intersection
from magics_tpu.env.sdf import env_to_sdf
from magics_tpu.graph import factors as JF
from magics_tpu.graph import tick as JT
from magics_tpu.kernels import gbp_slot as JG
from magics_tpu.kernels import hot as JHOT
from magics_tpu.sim.builder import build_scenario, circle_formation
from magics_tpu_torch.graph import factors as TF
from magics_tpu_torch.kernels import gbp_slot as TG

R_TILE = 8
TOL = {
    "belief_mean": 1e-2,
    "dyn_f2v_eta": 1e-3,
    "dyn_f2v_lam": 1e-3,
    "obs_f2v_eta": 1e-3,
    "trk_f2v_eta": 1e-3,
    "obs_v2f_mu": 1e-2,
    "trk_record": 0.0,
}


@pytest.fixture(scope="module")
def hot_inputs():
    specs = circle_formation(6, circle_radius=25.0, target_speed=10.0)
    params, state, _ = build_scenario(
        specs, target_speed=10.0, planning_horizon=3.0, hz=10.0,
        comms_radius=60.0, internal=6, external=3, n_slots=4,
        world=(100.0, 100.0), dtype=jnp.float32,
    )

    @jax.jit
    def pre_gbp(state):
        state = JT.activate_due_spawns(state)
        state = JT.check_waypoints(state, params)
        state = JT.update_connectivity(state, params)
        state = JT.update_prior_horizon(state, params)
        return JT.update_prior_current(state, params)

    st = pre_gbp(state)
    world = (params.world_width, params.world_height)
    sdf = jnp.asarray(env_to_sdf(intersection()), jnp.float32)
    hot = JHOT.to_hot(st, params, R_TILE)
    # obstacle factors linearise at the interior belief means, as after a
    # first slot (the initial obstacle inbox is empty, all at the origin)
    hot["obs_v2f_mu"] = hot["belief_mean"][:, 1:-1]
    rp = hot["belief_eta"].shape[-1]
    gate = JHOT._pad_r((st.active & (st.mission_active | st.completed)).astype(jnp.float32)[None], rp)
    h0, hx, hy = JF.obstacle_taps(
        jnp.moveaxis(hot["obs_v2f_mu"], 0, -1), sdf, world, dtype=jnp.float32, method="gather"
    )
    ext = JHOT._ext_sum_hot(st, rp)
    slot_in = {
        **hot, "gate": gate, "tgate": gate, "obs_h0": h0, "obs_hx": hx, "obs_hy": hy,
        "ext_sum_eta": ext[0], "ext_sum_lam": ext[1],
    }
    kw = dict(
        n_vars=params.n_vars, max_waypoints=params.max_waypoints,
        sigma_dynamics=params.sigma_factor_dynamics,
        sigma_obstacle=params.sigma_factor_obstacle,
        sigma_tracking=params.sigma_factor_tracking,
        obstacle_delta=JF.obstacle_delta(tuple(sdf.shape), world),
        switch_padding=params.tracking_switch_padding,
        attraction_distance=params.tracking_attraction_distance,
    )
    return {k: np.asarray(v) for k, v in slot_in.items()}, kw, np.asarray(sdf), world


def _torch_dict(arrays: dict, names) -> dict:
    return {n: torch.as_tensor(arrays[n].copy()) for n in names}


def _compare(want: dict, got: dict) -> None:
    """Each field within its tolerance, every vector or matrix relative to
    its own scale (TG.scaled_error), so the pinned endpoint rows do not
    set the scale of the interior ones."""
    want = {field: torch.as_tensor(np.array(w)) for field, w in want.items()}
    for field, w in want.items():
        assert tuple(got[field].shape) == tuple(w.shape), field
        tol = max(TOL.get(field, 1e-3), 1e-6)
        err = TG.scaled_error(field, got[field], want)
        assert err <= tol, (field, err)


@pytest.mark.parametrize("tracking", [True, False])
def test_internal_slot_reference_matches_pallas(hot_inputs, tracking):
    arrays, kw, _, _ = hot_inputs
    jp = JG.SlotParams(tracking_enabled=tracking, rtol=1e-4, **kw)
    run = jax.jit(lambda h: JG.internal_slot(h, jp, r_tile=R_TILE, interpret=True))
    # the Pallas call sizes its outputs from the same-named inputs
    want = run({n: jnp.asarray(arrays[n]) for n in JG._IN_FIELDS + JG._OUT_FIELDS})
    got = TG.internal_slot_reference(
        _torch_dict(arrays, TG._IN_FIELDS), TG.SlotParams(tracking_enabled=tracking, **kw)
    )
    _compare(want, got)
    # every factor kind carried messages in this slot
    for field in ("dyn_f2v_lam", "obs_f2v_lam") + (("trk_f2v_lam",) if tracking else ()):
        assert np.abs(np.asarray(want[field])).max() > 0, field


def _edge_points(arrays: dict, sdf: np.ndarray, world) -> np.ndarray:
    """obs_v2f_mu [4, V2, R] with the linearisation points moved onto the
    SDF's pixel edges (world x = j W_w / W - W_w / 2 in float32, so the pixel
    index sits on its knife edge), one step before an edge, past the image's
    far edges and below its near ones (the negative-saturating clamp)."""
    H, W = sdf.shape
    ww, wh = world
    mu = arrays["obs_v2f_mu"].copy()
    _, V2, R = mu.shape
    rng = np.random.default_rng(3)
    for k in range(V2):
        for r in range(R):
            kind = (k + r) % 5
            j, i = rng.integers(1, W), rng.integers(1, H)
            x = np.float32(j * ww / W - ww / 2.0)
            y = np.float32(wh / 2.0 - i * wh / H)
            if kind == 1:   # one float32 step before the edge
                x, y = np.nextafter(x, np.float32(-np.inf)), np.nextafter(y, np.float32(np.inf))
            if kind == 2:   # past the far edges
                x, y = np.float32(ww / 2.0 + 3.0 * rng.random()), np.float32(-wh / 2.0 - 1.0)
            if kind == 3:   # below the near edges: clamped to pixel 0
                x, y = np.float32(-ww / 2.0 - 7.0), np.float32(wh / 2.0 + 2.0)
            if kind < 4:
                mu[0, k, r], mu[1, k, r] = x, y
    return mu


def test_obstacle_taps_equal_jax_on_pixel_edges(hot_inputs):
    """The port's plain taps, which the kernel repeats operation for
    operation, are bit-equal to JAX's in float32 on pixel-edge points."""
    arrays, _, sdf, world = hot_inputs
    mu = np.moveaxis(_edge_points(arrays, sdf, world), 0, -1)
    want = JF.obstacle_taps(jnp.asarray(mu), jnp.asarray(sdf), world, dtype=jnp.float32,
                            method="gather")
    got = TF.obstacle_taps(torch.as_tensor(mu), torch.as_tensor(sdf.copy()), world)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert len({float(x) for x in np.asarray(want[0]).ravel()}) > 3   # a non-trivial SDF


@pytest.mark.parametrize("tracking", [True, False])
def test_fused_plain_version_matches_taps_and_pallas(hot_inputs, tracking):
    """The fused internal slot's plain version, given the SDF, against JAX
    `obstacle_taps` followed by the Pallas kernel in interpret mode."""
    arrays, kw, sdf, world = hot_inputs
    arrays = {**arrays, "obs_v2f_mu": _edge_points(arrays, sdf, world)}
    h0, hx, hy = JF.obstacle_taps(
        jnp.moveaxis(jnp.asarray(arrays["obs_v2f_mu"]), 0, -1), jnp.asarray(sdf), world,
        dtype=jnp.float32, method="gather",
    )
    jp = JG.SlotParams(tracking_enabled=tracking, rtol=1e-4, **kw)
    run = jax.jit(lambda h: JG.internal_slot(h, jp, r_tile=R_TILE, interpret=True))
    jin = {n: jnp.asarray(arrays[n]) for n in JG._IN_FIELDS + JG._OUT_FIELDS}
    want = run({**jin, "obs_h0": h0, "obs_hx": hx, "obs_hy": hy})
    tp = TG.SlotParams(tracking_enabled=tracking, **kw)
    got = TG.internal_slot(
        _torch_dict(arrays, TG._KERNEL_IN_FIELDS), torch.as_tensor(sdf.copy()), world, tp
    )
    _compare(want, got)
    assert np.abs(np.asarray(want["obs_f2v_lam"])).max() > 0


def _variable_slot_against_pallas(arrays: dict, kw: dict) -> dict:
    jp = JG.SlotParams(rtol=1e-4, **kw)
    run = jax.jit(lambda h: JG.variable_slot(h, jp, r_tile=R_TILE, interpret=True))
    want = run({n: jnp.asarray(arrays[n]) for n in JG._VAR_IN_FIELDS})
    got = TG.variable_slot(_torch_dict(arrays, TG._VAR_IN_FIELDS), TG.SlotParams(**kw))
    _compare(want, got)
    return got


def test_variable_slot_reference_matches_pallas(hot_inputs):
    arrays, kw, _, _ = hot_inputs
    _variable_slot_against_pallas(arrays, kw)


def test_variable_slot_reference_matches_pallas_gated_off(hot_inputs):
    """Part of the swarm gated off (robots 1 and 4, besides the padding):
    those keep their old beliefs, the others update."""
    arrays, kw, _, _ = hot_inputs
    gate = arrays["gate"].copy()
    assert (gate[0, [0, 1, 4]] > 0).all()
    gate[0, [1, 4]] = 0.0
    got = _variable_slot_against_pallas({**arrays, "gate": gate}, kw)
    for name in TG._VAR_OUT_FIELDS:
        old = arrays[name][..., [1, 4]]
        np.testing.assert_array_equal(got[name][..., [1, 4]].numpy(), old)
    on = [0, 2, 3, 5]
    assert any(not np.array_equal(got[n][..., on].numpy(), arrays[n][..., on])
               for n in TG._VAR_OUT_FIELDS)


def test_scaled_error_sees_interior_faults(hot_inputs):
    """Planted faults in the interior rows: a response whose incoming
    message was not subtracted, and a snapshot taken before the update. The
    per-vector scale catches both; a scale taken over the whole field, set
    by the 1e30-pinned endpoint rows, would not."""
    arrays, kw, _, _ = hot_inputs
    want = TG.internal_slot_reference(_torch_dict(arrays, TG._IN_FIELDS), TG.SlotParams(**kw))
    planted = {
        "dyn_v2f_lam": want["dyn_v2f_lam"] + want["dyn_f2v_lam"],
        "snap_lam": torch.as_tensor(arrays["belief_lam"].copy()),
    }
    for field, bad in planted.items():
        assert TG.scaled_error(field, bad, want) > 1e-2, field
        whole_field = float((bad - want[field]).abs().max() / want[field].abs().max())
        assert whole_field < 1e-3, field


def test_field_tables_match_pallas():
    assert TG._IN_FIELDS == JG._IN_FIELDS
    assert TG._OUT_FIELDS == JG._OUT_FIELDS
    assert TG._KERNEL_IN_FIELDS == tuple(n for n in JG._IN_FIELDS if n not in TG._TAP_FIELDS)
    assert TG._VAR_IN_FIELDS == JG._VAR_IN_FIELDS
    assert TG._VAR_OUT_FIELDS == JG._VAR_OUT_FIELDS
    port = {f.name for f in dataclasses.fields(TG.SlotParams)}
    assert port == {f.name for f in dataclasses.fields(JG.SlotParams)} - {"rtol"}

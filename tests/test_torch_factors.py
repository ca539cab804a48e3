"""The port's factor functions (magics_tpu_torch/graph/factors.py) against
magics_tpu's graph/factors.py on the same seeded float64 inputs, each output
within rtol 1e-9 of its scale; integer and boolean outputs equal. The JAX
side always runs under `jax.jit`.

Obstacle taps read a non-trivial SDF (the built-in "intersection"
environment, rasterised); tracking runs on a multi-segment route whose
final segment is shorter than the switch padding, the geometry of the
corner fix (tests/test_tracking_corner.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.env.builtin import intersection
from magics_tpu.env.sdf import env_to_sdf
from magics_tpu.graph import factors as JF
from magics_tpu_torch.graph import factors as TF

RTOL = 1e-9
WORLD = (100.0, 100.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
        return
    a, b = a.astype(np.float64), b.astype(np.float64)
    scale = max(np.abs(a).max(initial=0.0), 1.0)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max()


def _psd(rng, shape, scale=1.0):
    a = rng.normal(size=shape + (4, 4))
    return scale * (a @ np.swapaxes(a, -1, -2))


def test_dynamic_factor_messages():
    rng = np.random.default_rng(0)
    R, E = 6, 9
    v2f_eta = rng.normal(size=(R, E, 2, 4))
    v2f_lam = _psd(rng, (R, E, 2), scale=50.0)
    v2f_lam[0] = 0.0                       # empty cavities -> empty messages
    v2f_lam[1, :, 0] += 1e30 * np.eye(4)   # an endpoint pinned at 1e30
    v2f_mu = rng.normal(size=(R, E, 2, 4))
    delta_t = rng.uniform(0.05, 2.0, size=(R, E))
    args = (v2f_eta, v2f_lam, v2f_mu, delta_t)
    fj = jax.jit(partial(JF.dynamic_factor_messages, sigma=0.1, dtype=jnp.float64))
    got_j = fj(*map(jnp.asarray, args))
    got_t = TF.dynamic_factor_messages(*map(_t, args), sigma=0.1, dtype=torch.float64)
    for a, b in zip(got_j, got_t):
        _close(a, b.numpy())
    assert np.abs(np.asarray(got_j[1])).max() > 0


def test_obstacle_delta():
    assert TF.obstacle_delta((200, 128), WORLD) == JF.obstacle_delta((200, 128), WORLD)


@pytest.fixture(scope="module")
def sdf():
    img = env_to_sdf(intersection())
    assert 0.0 < img.min() or img.max() < 1.0   # not the all-ones bench image
    return img.astype(np.float64)


@pytest.fixture(scope="module")
def obstacle_mu():
    rng = np.random.default_rng(1)
    mu = rng.uniform(-55.0, 55.0, size=(12, 15, 4))   # some past the image edge
    mu[..., 2:] = rng.normal(size=(12, 15, 2))
    return mu


def test_obstacle_taps(sdf, obstacle_mu):
    fj = jax.jit(partial(JF.obstacle_taps, world_size=WORLD, dtype=jnp.float64, method="gather"))
    got_j = fj(jnp.asarray(obstacle_mu), jnp.asarray(sdf))
    got_t = TF.obstacle_taps(_t(obstacle_mu), _t(sdf), WORLD, dtype=torch.float64)
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the taps see the obstacles: finite differences are not all zero
    assert np.abs(np.asarray(got_j[1]) - np.asarray(got_j[0])).max() > 0


def test_obstacle_messages_from_taps(sdf, obstacle_mu):
    taps = jax.jit(partial(JF.obstacle_taps, world_size=WORLD, dtype=jnp.float64, method="gather"))(
        jnp.asarray(obstacle_mu), jnp.asarray(sdf)
    )
    taps = [np.asarray(x) for x in taps]
    delta = JF.obstacle_delta(sdf.shape, WORLD)
    fj = jax.jit(partial(JF.obstacle_messages_from_taps, delta=delta, sigma=0.01, dtype=jnp.float64))
    got_j = fj(*map(jnp.asarray, taps), jnp.asarray(obstacle_mu))
    got_t = TF.obstacle_messages_from_taps(
        *map(_t, taps), _t(obstacle_mu), delta, 0.01, dtype=torch.float64
    )
    for a, b in zip(got_j, got_t):
        _close(a, b.numpy())
    assert np.abs(np.asarray(got_j[1])).max() > 0


# the Solo GP final-approach geometry: a long segment into a corner, then a
# 3.3 m final segment, shorter than the switch padding of 5.0
CORNER_PATH = [(89.4, 52.56), (103.99, 52.25), (106.25, 49.875)]


def _tracking_inputs(seed: int):
    rng = np.random.default_rng(seed)
    R, Fn, W = 5, 24, 4
    path = np.zeros((R, W, 2))
    path[:, :3] = CORNER_PATH
    path_len = np.array([3, 3, 3, 2, 1], dtype=np.int32)   # incl. done / degenerate
    path[3, :2] = [(0.0, 0.0), (10.0, 5.0)]
    # variables scattered around the corner, behind it and past it
    xy = rng.uniform([88.0, 47.0], [108.0, 55.0], size=(R, Fn, 2))
    mu = np.concatenate([xy, rng.normal(scale=3.0, size=(R, Fn, 2))], axis=-1)
    record = rng.integers(-1, 3, size=(R, Fn)).astype(np.int32)
    timeout = rng.choice([-1, -1, -1, 0, 2], size=(R, Fn)).astype(np.int32)
    index = np.full(R, 2, dtype=np.int32)
    return mu, path, path_len, record, index, timeout


@pytest.mark.parametrize("seed", [0, 1])
def test_tracking_factor_messages_corner_route(seed):
    args = _tracking_inputs(seed)
    kw = dict(switch_padding=5.0, attraction_distance=2.0, sigma=0.15)
    fj = jax.jit(partial(JF.tracking_factor_messages, dtype=jnp.float64, **kw))
    got_j = fj(*map(jnp.asarray, args))
    got_t = TF.tracking_factor_messages(*map(_t, args), dtype=torch.float64, **kw)
    for a, b in zip(got_j, got_t):
        _close(a, b.numpy())
    skipped = np.asarray(got_j[6])
    assert skipped.any() and not skipped.all()


@pytest.fixture(scope="module")
def snap_tables_inputs():
    rng = np.random.default_rng(2)
    R, V = 7, 9
    snap_mu = rng.normal(scale=20.0, size=(R, V, 4))
    snap_eta = rng.normal(size=(R, V, 4))
    snap_lam = _psd(rng, (R, V), scale=3.0) + 0.01 * np.eye(4)
    snap_lam[:, -1] += 1e30 * np.eye(4)      # the pinned horizon variable
    snap_lam[0, 3] = 0.0                     # an empty (invalid) cavity
    return snap_mu, snap_eta, snap_lam


def test_compact_snap_tables(snap_tables_inputs):
    fj = jax.jit(partial(JF.compact_snap_tables, dtype=jnp.float64))
    got_j = fj(*map(jnp.asarray, snap_tables_inputs))
    got_t = TF.compact_snap_tables(*map(_t, snap_tables_inputs), dtype=torch.float64)
    _close(got_j, got_t.numpy())
    valid = np.asarray(got_j)[..., 7]
    assert (valid == 0).any() and (valid == 1).any()


def test_interrobot_rank1_messages_compact(snap_tables_inputs):
    tables = np.asarray(
        jax.jit(partial(JF.compact_snap_tables, dtype=jnp.float64))(
            *map(jnp.asarray, snap_tables_inputs)
        )
    )  # [R, V1, 8]
    rng = np.random.default_rng(3)
    R, V1 = tables.shape[:2]
    K = 5
    peer = rng.integers(0, R, size=(R, K))
    tab = tables[peer]                                     # [R, K, V1, 8]
    seeded = rng.random((R, K, V1)) > 0.2
    p_ext = tab[..., 0:2] + rng.normal(scale=3.0, size=(R, K, V1, 2))
    safety = np.full((R, K, V1), 4.4)
    tiny = 1e-6 * (np.arange(R * K * V1).reshape(R, K, V1) + 1.0)
    args = (tab, seeded, p_ext, safety, tiny)
    fj = jax.jit(partial(JF.interrobot_rank1_messages_compact, sigma=0.01, dtype=jnp.float64))
    got_j = fj(*map(jnp.asarray, args))
    got_t = TF.interrobot_rank1_messages_compact(*map(_t, args), sigma=0.01, dtype=torch.float64)
    _close(got_j, got_t.numpy())
    s = np.asarray(got_j)[..., 3]
    assert (s == 0).any() and (s != 0).any()   # both empty and live messages


@pytest.fixture(scope="module")
def rank1_msgs():
    rng = np.random.default_rng(4)
    msg = rng.normal(size=(6, 5, 8, 4))
    msg[..., 3] = np.abs(msg[..., 3])
    return msg


def test_rank1_eta_lam(rank1_msgs):
    got_j = jax.jit(JF.rank1_eta_lam)(jnp.asarray(rank1_msgs))
    got_t = TF.rank1_eta_lam(_t(rank1_msgs))
    for a, b in zip(got_j, got_t):
        _close(a, b.numpy())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rank1_sum(rank1_msgs, axis):
    got_j = jax.jit(partial(JF.rank1_sum, axis=axis))(jnp.asarray(rank1_msgs))
    got_t = TF.rank1_sum(_t(rank1_msgs), dim=axis)
    for a, b in zip(got_j, got_t):
        _close(a, b.numpy())


@pytest.fixture(scope="module")
def interrobot_inputs():
    """Inter-robot factors [R, K, V1] around the safety distance: live
    pairs, skipped ones (raw distance past the safety distance), unseeded
    internal cavities (zero), near-singular ones (precision on the velocity
    only, plus a 1e-9 position trace) and an endpoint pinned at 1e30."""
    rng = np.random.default_rng(6)
    R, K, V1 = 5, 4, 6
    shape = (R, K, V1)
    x_int = rng.normal(scale=3.0, size=shape + (4,))
    x_ext = x_int + rng.normal(scale=2.5, size=shape + (4,))
    safety = np.full(shape, 4.4)
    tiny = 1e-6 * (np.arange(R * K * V1).reshape(shape) + 1.0)
    cav_eta = rng.normal(size=shape + (4,))
    cav_lam = _psd(rng, shape, scale=2.0) + 0.05 * np.eye(4)
    cav_lam[0] = 0.0
    cav_eta[0] = 0.0
    near = np.zeros((4, 4))
    near[2:, 2:] = np.eye(2)
    near[:2, :2] = 1e-9 * np.eye(2)
    cav_lam[1, :2] = near
    cav_lam[2, 0, -1] += 1e30 * np.eye(4)
    ext_eta = rng.normal(size=shape + (4,))
    ext_lam = _psd(rng, shape, scale=2.0) + 0.05 * np.eye(4)
    return dict(
        x_int=x_int, x_ext=x_ext, cav_eta=cav_eta, cav_lam=cav_lam,
        ext_eta=ext_eta, ext_lam=ext_lam, safety=safety, tiny=tiny,
    )


def _dense_args(d):
    return (d["x_int"], d["x_ext"], d["cav_eta"], d["cav_lam"], d["ext_eta"],
            d["ext_lam"], d["safety"], d["tiny"])


def _rank1_args(d):
    return (d["x_int"], d["x_ext"][..., :2], d["cav_eta"], d["cav_lam"], d["safety"], d["tiny"])


def test_interrobot_factor_messages(interrobot_inputs):
    args = _dense_args(interrobot_inputs)
    fj = jax.jit(partial(JF.interrobot_factor_messages, sigma=0.5, dtype=jnp.float64))
    got_j = fj(*map(jnp.asarray, args))
    got_t = TF.interrobot_factor_messages(*map(_t, args), sigma=0.5, dtype=torch.float64)
    for a, b in zip(got_j, got_t):
        _close(a, b.numpy())
    skipped = np.asarray(got_j[4])
    assert skipped.any() and not skipped.all()


def test_interrobot_rank1_messages(interrobot_inputs):
    args = _rank1_args(interrobot_inputs)
    fj = jax.jit(partial(JF.interrobot_rank1_messages, sigma=0.5, dtype=jnp.float64))
    got_j = np.asarray(fj(*map(jnp.asarray, args)))
    got_t = TF.interrobot_rank1_messages(*map(_t, args), sigma=0.5, dtype=torch.float64)
    _close(got_j, got_t.numpy())
    np.testing.assert_array_equal(got_j == 0, got_t.numpy() == 0)
    live = got_j[..., 3] != 0
    assert live.any() and not live[0].any() and not live[1, :2].any()


def test_rank1_form_is_the_dense_external_message(interrobot_inputs):
    """The rank-1 message (g t, s g g^T) is the dense 8x8 form's message to
    the external variable, guards included (both port functions)."""
    d = interrobot_inputs
    msg = TF.interrobot_rank1_messages(*map(_t, _rank1_args(d)), sigma=0.5, dtype=torch.float64)
    _, _, ext_eta, ext_lam, _ = TF.interrobot_factor_messages(
        *map(_t, _dense_args(d)), sigma=0.5, dtype=torch.float64
    )
    eta, lam = TF.rank1_eta_lam(msg)
    _close(ext_eta.numpy(), eta.numpy())
    _close(ext_lam.numpy(), lam.numpy())
    np.testing.assert_array_equal((ext_lam == 0).all(-1).all(-1).numpy(), (msg == 0).all(-1).numpy())

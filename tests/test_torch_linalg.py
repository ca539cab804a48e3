"""The port's closed-form 4x4 algebra (magics_tpu_torch/core/linalg.py)
against magics_tpu's core/linalg.py on the same seeded inputs.

float64 pins the maths (each output within 1e-10 of its scale); float32 pins
the guard decisions (the validity masks are equal). The JAX side always runs
under `jax.jit`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.core import linalg as JL
from magics_tpu_torch.core import linalg as TL

ATOL = 1e-10


def _spd(rng, n, scale=1.0):
    a = rng.normal(size=(n, 4, 4))
    return scale * (a @ np.swapaxes(a, -1, -2)) + 0.1 * np.eye(4)


def _precisions(seed: int) -> np.ndarray:
    """A batch of belief-like precisions: well-conditioned, pinned at 1e30
    (the endpoint priors), rank-deficient (rank-1 inter-robot potentials),
    nearly singular, zero, and mixed-scale rows."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(8, 4, 1))
    rank1 = g @ np.swapaxes(g, -1, -2)
    near = rank1 + 1e-9 * np.eye(4)
    pinned = np.eye(4) * 1e30 + _spd(rng, 8)
    mixed = _spd(rng, 8)
    mixed[:, 0, 0] *= 1e8
    return np.concatenate(
        [_spd(rng, 32), _spd(rng, 8, 1e4), pinned, rank1, near, np.zeros((2, 4, 4)), mixed]
    )


def _close(a, b, atol=ATOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    fa, fb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(fa, fb)
    scale = max(np.abs(a[fa]).max(initial=0.0), 1.0)
    assert np.abs(a[fa] - b[fa]).max(initial=0.0) <= atol * scale


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_inv4(seed):
    m = _precisions(seed)
    # the plain inverse of a (nearly) singular matrix is inf/nan or noise:
    # compare the well-conditioned ones
    m = m[np.linalg.cond(m) < 1e6]
    inv_j, det_j = jax.jit(JL.inv4)(jnp.asarray(m))
    inv_t, det_t = TL.inv4(_t(m))
    _close(inv_j, inv_t.numpy())
    _close(det_j, det_t.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_inv4_rowscaled(seed):
    m = _precisions(seed)
    inv_j, det_j = jax.jit(JL.inv4_rowscaled)(jnp.asarray(m))
    inv_t, det_t = TL.inv4_rowscaled(_t(m))
    _close(det_j, det_t.numpy())
    ok = np.abs(np.asarray(det_j)) > 1e-12  # compare the invertible ones
    _close(np.asarray(inv_j)[ok], inv_t.numpy()[ok])


@pytest.mark.parametrize("seed", [0, 1])
def test_belief_covariance(seed):
    m = _precisions(seed)
    cov_j, valid_j = jax.jit(JL.belief_covariance)(jnp.asarray(m))
    cov_t, valid_t = TL.belief_covariance(_t(m))
    np.testing.assert_array_equal(np.asarray(valid_j), valid_t.numpy())
    v = np.asarray(valid_j)
    assert v.any() and not v.all()
    _close(np.asarray(cov_j)[v], cov_t.numpy()[v])


def _potentials(seed: int):
    """Two-block factor potentials: full-rank, rank-1 (inter-robot like),
    singular lam_bb, and tiny (negligible) ones."""
    rng = np.random.default_rng(seed)
    n = 24
    J = rng.normal(size=(n, 2, 8))
    lam = np.swapaxes(J, -1, -2) @ J + 0.05 * np.eye(8)
    g = rng.normal(size=(8, 1, 8))
    lam = np.concatenate([lam, np.swapaxes(g, -1, -2) @ g, 1e-14 * (lam[:4])])
    lam[n : n + 2, 4:, 4:] = 0.0   # singular lam_bb
    eta = rng.normal(size=(lam.shape[0], 8))
    return (eta[:, :4], eta[:, 4:], lam[:, :4, :4], lam[:, :4, 4:], lam[:, 4:, :4], lam[:, 4:, 4:])


@pytest.mark.parametrize("seed", [0, 1])
def test_marginalize_two_block(seed):
    args = _potentials(seed)
    eta_j, lam_j, valid_j = jax.jit(JL.marginalize_two_block)(*map(jnp.asarray, args))
    eta_t, lam_t, valid_t = TL.marginalize_two_block(*map(_t, args))
    np.testing.assert_array_equal(np.asarray(valid_j), valid_t.numpy())
    v = np.asarray(valid_j)
    assert v.any() and not v.all()
    _close(eta_j, eta_t.numpy())
    _close(lam_j, lam_t.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_validity_masks_equal(seed):
    m = _precisions(seed).astype(np.float32)
    _, valid_j = jax.jit(JL.belief_covariance)(jnp.asarray(m))
    _, valid_t = TL.belief_covariance(_t(m))
    np.testing.assert_array_equal(np.asarray(valid_j), valid_t.numpy())

    args = [a.astype(np.float32) for a in _potentials(seed)]
    *_, mvalid_j = jax.jit(JL.marginalize_two_block)(*map(jnp.asarray, args))
    *_, mvalid_t = TL.marginalize_two_block(*map(_t, args))
    np.testing.assert_array_equal(np.asarray(mvalid_j), mvalid_t.numpy())


def test_mm_mtm_mv_match():
    rng = np.random.default_rng(3)
    a, b, v = rng.normal(size=(5, 4, 4)), rng.normal(size=(5, 4, 4)), rng.normal(size=(5, 4))
    for jf, tf, args in (
        (JL.mm, TL.mm, (a, b)), (JL.mtm, TL.mtm, (a, b)), (JL.mv, TL.mv, (a, v))
    ):
        _close(jax.jit(jf)(*map(jnp.asarray, args)), tf(*map(_t, args)).numpy())

"""The port's MultivariateNormal (core/gaussian.py) against the JAX
package's on the four cases of tests/test_gaussian_analysis.py, in float64
(pytest's conftest turns JAX's x64 on): means, covariances, information
vectors and precisions within 1e-10; a singular matrix raises
NotPositiveSemiDefinite in both. Also batched inputs and the device the
tensors stay on."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.core import gaussian as JG
from magics_tpu_torch.core import gaussian as TG

TOL = 1e-10


def _close(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


def _both(ctor, *args):
    """The same constructor of both packages on the same float64 inputs."""
    args = [np.asarray(a, dtype=np.float64) for a in args]
    j = getattr(JG.MultivariateNormal, ctor)(*(jnp.asarray(a) for a in args))
    t = getattr(TG.MultivariateNormal, ctor)(*(torch.from_numpy(a) for a in args))
    assert t.eta.dtype == torch.float64 and t.dims == j.dims
    return j, t


def _same(j, t):
    _close(t.mean(), j.mean())
    _close(t.covariance(), j.covariance())
    _close(t.information_vector(), j.information_vector())
    _close(t.precision_matrix(), j.precision_matrix())


def test_roundtrip_mean_cov():
    mean = [1.0, -2.0, 0.5]
    cov = [[2.0, 0.3, 0.0], [0.3, 1.0, 0.1], [0.0, 0.1, 0.5]]
    j, t = _both("from_mean_and_covariance", mean, cov)
    _same(j, t)
    _close(t.mean(), mean)
    _close(t.covariance(), cov)


def test_from_information():
    j, t = _both("from_information_and_precision", [4.0, 8.0], np.eye(2) * 4.0)
    _same(j, t)
    _close(t.mean(), [1.0, 2.0])
    assert t.dims == 2


def test_product_is_information_sum():
    ja, ta = _both("from_mean_and_precision", [0.0], np.eye(1))
    jb, tb = _both("from_mean_and_precision", [2.0], np.eye(1))
    _same(ja * jb, ta * tb)
    _close((ta * tb).mean(), [1.0])
    _close((ta * tb).precision_matrix(), [[2.0]])
    _same(ja * jb / jb, ta * tb / tb)
    _close((ta * tb / tb).mean(), [0.0])
    _same(ja.add_assign_information(jb.eta, jb.lam), ta.add_assign_information(tb.eta, tb.lam))


def test_singular_rejected():
    for ctor in ("from_mean_and_covariance", "from_mean_and_precision"):
        with pytest.raises(JG.NotPositiveSemiDefinite):
            _both(ctor, np.zeros(2), np.zeros((2, 2)))
        with pytest.raises(TG.NotPositiveSemiDefinite):
            getattr(TG.MultivariateNormal, ctor)(torch.zeros(2, dtype=torch.float64),
                                                 torch.zeros(2, 2, dtype=torch.float64))
    assert issubclass(TG.NotPositiveSemiDefinite, ValueError)
    t = TG.MultivariateNormal(torch.zeros(2, dtype=torch.float64),
                              torch.ones(2, 2, dtype=torch.float64))
    with pytest.raises(TG.NotPositiveSemiDefinite):
        t.mean()


def test_batched_and_on_the_tensors_device():
    """Leading axes broadcast; one singular matrix in a batch rejects it."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 4, 4))
    cov = a @ np.swapaxes(a, -1, -2) + 4 * np.eye(4)
    mean = rng.standard_normal((5, 4))
    j, t = _both("from_mean_and_covariance", mean, cov)
    _same(j, t)
    assert t.eta.device == t.lam.device == torch.device("cpu")
    cov[2] = 0.0
    with pytest.raises(TG.NotPositiveSemiDefinite):
        TG.MultivariateNormal.from_mean_and_covariance(torch.from_numpy(mean),
                                                       torch.from_numpy(cov))

"""The external sums' plain version (magics_tpu_torch/kernels/ext_sum.py,
what the wrapper runs on CPU tensors) against magics_tpu's
kernels/hot.py:_ext_sum_hot, sliced to R robots, on seeded inboxes with
empty slots and robots, float64 and float32, each entry within summation
roundoff of its terms (`ext_sum.sum_tolerance`: the two frameworks sum over
k in their own orders). Also each robot's sums alone, and the hot loop's
`_ext_sum_hot` on a CPU state: the plain version, no launch counted.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.kernels import hot as JHOT
from magics_tpu_torch.kernels import ext_sum as E
from magics_tpu_torch.kernels import hot as HOT


def seeded_inbox(R: int, K: int, V1: int, seed: int = 0) -> np.ndarray:
    """[R, K, V1, 4] of (gx, gy, t, s), s >= 0, about a third of the slots
    and every seventh robot empty (all zero), as an inbox holds them."""
    rng = np.random.default_rng(seed)
    inbox = rng.normal(scale=2.0, size=(R, K, V1, 4))
    inbox[..., 3] = np.abs(inbox[..., 3])
    inbox[rng.random((R, K)) < 0.35] = 0.0
    inbox[::7] = 0.0
    return inbox


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R, K, V1", [(13, 6, 20), (50, 49, 20), (9, 1, 2)])
def test_ext_sum_plain_matches_jax(dtype, R, K, V1):
    inbox = seeded_inbox(R, K, V1).astype(dtype)
    rp = -(-R // 8) * 8
    want = jax.jit(lambda a: JHOT._ext_sum_hot(SimpleNamespace(ext_inbox=a), rp))(
        jnp.asarray(inbox))
    x = torch.as_tensor(inbox)
    before = dict(E.launch_counts)
    got = E.ext_sum_hot(x)
    assert E.launch_counts == before   # the CPU runs the plain version, no launch
    tol = E.sum_tolerance(x)
    for g, w, t in zip(got, want, tol):
        w = np.asarray(w)[..., :R]
        assert g.dtype == x.dtype and tuple(g.shape) == w.shape
        assert tuple(g.shape[-2:]) == (V1 + 1, R)
        err = np.abs(g.double().numpy() - w.astype(np.float64))
        assert (err <= t.numpy()).all(), float((err - t.numpy()).max())
        assert not g[..., 0, :].any()   # variable 0: no external factor
    assert got[0][:2].abs().sum() > 0 and got[1][:2, :2].abs().sum() > 0
    assert not got[0][2:].any() and not got[1][2:].any() and not got[1][:, 2:].any()


def test_hot_loop_sums_through_the_wrapper():
    """`_ext_sum_hot(state)` is the wrapper on the state's inbox."""
    x = torch.as_tensor(seeded_inbox(11, 4, 6, seed=3)).float()
    got = HOT._ext_sum_hot(SimpleNamespace(ext_inbox=x))
    want = E.ext_sum_hot_reference(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("R, K, V1", [
    (1, 1, 1), (13, 6, 20), (50, 49, 20), (37, 7, 20), (20, 3, 69), (9, 1, 2),
])
def test_plain_sums_robot_by_robot(R, K, V1):
    """Each robot's planes are its own inbox's sums: the same bits summed
    with the others or alone (a shard sums as the whole), lam's two
    off-diagonal position entries equal, and an empty robot's planes and
    tolerance zero."""
    x = torch.as_tensor(seeded_inbox(R, K, V1, seed=R * K + V1)).float()
    eta, lam = E.ext_sum_hot(x)
    assert torch.equal(lam[0, 1], lam[1, 0])
    for r in {0, R // 2, R - 1}:
        one = E.ext_sum_hot(x[r:r + 1].contiguous())
        assert torch.equal(one[0], eta[..., r:r + 1])
        assert torch.equal(one[1], lam[..., r:r + 1])
    tol_eta, tol_lam = E.sum_tolerance(x)
    assert not eta[..., 0].any() and not lam[..., 0].any()   # robot 0 is empty
    assert not tol_eta[..., 0].any() and not tol_lam[..., 0].any()


def test_wrapper_refuses_a_device_without_the_kernel():
    x = torch.empty((4, 3, 5, 4), device="meta")
    before = dict(E.launch_counts)
    with pytest.raises(ValueError):
        E.ext_sum_hot(x)
    assert E.launch_counts == before

"""The row gather (magics_tpu_torch/kernels/layout.py) and the exchange's
gather helpers built on it (graph/exchange.py), against magics_tpu's `_gather_from_peer` and
`_gather_rows_pinned` (their `layout_pin` is the identity on the CPU), on
seeded tables with masked slots and indexes the callers must clip (-1 for a
dead slot, and past the table's end). A gather moves values without
arithmetic, so every comparison is bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magics_tpu.graph import tick as JT
from magics_tpu_torch.graph import exchange as EX
from magics_tpu_torch.kernels import layout as L

R, K, V1 = 9, 5, 7


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(5)
    arr = rng.normal(size=(R, K, V1, 4))                  # an outbox [R, K, V-1, 4]
    nbr_idx = rng.integers(-1, R + 3, size=(R, K)).astype(np.int32)
    back = rng.integers(-2, K + 2, size=(R, K)).astype(np.int32)
    mask = rng.random((R, K)) > 0.3
    return arr, nbr_idx, back, mask


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gather_from_peer_matches_jax(tables, dtype):
    arr, nbr_idx, back, mask = tables
    arr = arr.astype(dtype)
    want = np.asarray(jax.jit(JT._gather_from_peer)(*map(jnp.asarray, (arr, nbr_idx, back, mask))))
    got = EX.gather_from_peer(*map(_t, (arr, nbr_idx, back, mask))).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all(axis=(2, 3))[~mask].all() and (got != 0).any()


def test_gather_rows_pinned_matches_jax(tables):
    arr, nbr_idx, _, _ = tables
    pack = arr.reshape(R, -1)                             # [R, K * V1 * 4]
    src = np.clip(nbr_idx, 0, R - 1)                      # clipped by the caller
    want = np.asarray(jax.jit(JT._gather_rows_pinned)(jnp.asarray(pack), jnp.asarray(src)))
    got = EX.gather_rows_pinned(_t(pack), _t(src)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_robot_matches_jax(tables):
    """The per-robot gather the sender's seeding of new factors uses (plain
    indexing in both packages)."""
    arr, nbr_idx, _, mask = tables
    pos = arr[:, 0, :, :2]                                # [R, V1, 2]
    args = (pos, nbr_idx, mask)
    want = np.asarray(jax.jit(JT._gather_robot)(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(EX.gather_robot(*map(_t, args)).numpy(), want)


@pytest.mark.parametrize(
    "dtype, width",
    [(torch.float32, 80), (torch.float32, 3), (torch.float64, 5), (torch.int32, 7),
     (torch.bool, 6), (torch.uint8, 13)],
)
@pytest.mark.parametrize("masked", [False, True])
def test_gather_rows_is_index_select(dtype, width, masked):
    """Any dtype and row size, with and without a mask: the plain version
    is `index_select`, zeroed where the mask is false."""
    g = torch.Generator().manual_seed(width)
    table = (torch.randn(11, width, generator=g) * 100).to(dtype)
    idx = torch.randint(0, 11, (17,), generator=g)
    mask = torch.rand(17, generator=g) > 0.4 if masked else None
    out = L.gather_rows(table, idx, mask)
    want = table.index_select(0, idx)
    if masked:
        want[~mask] = 0
    assert out.dtype == dtype and torch.equal(out, want)
    assert L.launch_counts["gather_rows"] == 0            # CPU: no kernel launch


@pytest.mark.parametrize(
    "dtype, width",
    [(torch.float32, 80), (torch.float32, 40), (torch.float32, 3), (torch.float64, 5),
     (torch.int32, 7), (torch.bool, 6)],
)
def test_gather_rows_with_old_is_the_where(dtype, width):
    """With old rows the plain version is `where(mask, index_select, old)`,
    bit for bit (NaNs of the old rows included); without them, the zeros."""
    g = torch.Generator().manual_seed(width)
    table = (torch.randn(11, width, generator=g) * 100).to(dtype)
    idx = torch.randint(0, 11, (17,), generator=g)
    mask = torch.rand(17, generator=g) > 0.4
    old = (torch.randn(17, width, generator=g) * 100).to(dtype)
    if dtype.is_floating_point:
        old.view(-1)[::3] = float("nan")
    got = L.gather_rows(table, idx, mask, old)
    want = torch.where(mask[:, None], table.index_select(0, idx), old)
    assert got.dtype == dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(L.gather_rows(table, idx, mask),
                       torch.where(mask[:, None], table.index_select(0, idx),
                                   torch.zeros_like(old)))
    assert L.launch_counts["gather_rows"] == 0            # CPU: no kernel launch


def test_sender_gathers_with_old_are_the_selects_they_replace(tables):
    """The sender's delivery and response gathers with the old rows equal
    the masked gather followed by the select on `deliver`, a subset of the
    live slots, as the exchange ran them before (`deliver` implies
    `nbr_mask`, so the zeros the select replaces were never kept)."""
    arr, nbr_idx, back, mask = map(_t, tables)
    g = torch.Generator().manual_seed(9)
    deliver = mask & (torch.rand(mask.shape, generator=g) > 0.3)
    old = torch.randn(arr.shape, generator=g, dtype=arr.dtype)
    got = EX.gather_from_peer(arr, nbr_idx, back, deliver, old)
    want = torch.where(deliver[..., None, None], EX.gather_from_peer(arr, nbr_idx, back, mask), old)
    assert torch.equal(got, want)
    assert bool(deliver.any()) and bool((mask & ~deliver).any())
    pos = arr[:, 0, :, :2].contiguous()                   # [R, V1, 2]
    src = nbr_idx.clamp(0, R - 1).long()
    old_pos = torch.randn((R, K, V1, 2), generator=g, dtype=arr.dtype)
    got = EX.gather_rows_pinned(pos, src, deliver, old_pos)
    want = torch.where(deliver[..., None, None], EX.gather_rows_pinned(pos, src, mask), old_pos)
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize(
    "bad",
    ["idx_int32", "idx_2d", "table_1d", "mask_dtype", "mask_shape", "meta_device",
     "old_without_mask", "old_dtype", "old_shape"],
)
def test_gather_rows_refuses_what_it_does_not_take(bad):
    table, idx, mask = torch.zeros(4, 3), torch.zeros(5, dtype=torch.int64), None
    old = None
    if bad == "idx_int32":
        idx = idx.int()
    elif bad == "idx_2d":
        idx = idx[:, None]
    elif bad == "table_1d":
        table = table[:, 0]
    elif bad == "mask_dtype":
        mask = torch.ones(5)
    elif bad == "mask_shape":
        mask = torch.ones(4, dtype=torch.bool)
    elif bad == "old_without_mask":
        old = torch.zeros(5, 3)
    elif bad.startswith("old_"):
        mask = torch.ones(5, dtype=torch.bool)
        old = torch.zeros(5, 3, dtype=torch.float64) if bad == "old_dtype" else torch.zeros(5, 4)
    else:
        table, idx = table.to("meta"), idx.to("meta")
    with pytest.raises((TypeError, ValueError)):
        L.gather_rows(table, idx, mask, old)

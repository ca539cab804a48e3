"""Spatial-grid neighbour search, the O(R) replacement for the dense [R, R]
scans of connectivity and collisions (counterpart of magics_tpu's
graph/grid.py, whose docstring explains the design).

Robots are binned into a uniform grid of cells; each robot's pair search
runs over the buckets of a static stencil of (2 reach + 1)^2 cells around
it, M = stencil x capacity candidates, with the exact distance test still
run on them. Every shape is static, so a tick on the grid path captures in
a CUDA graph like the dense one.

Three points where PyTorch differs from JAX, each kept to the JAX
package's results entry for entry:

- JAX scatters the buckets with `mode="drop"`: robots ranked past the
  capacity leave no entry. A CUDA scatter with an index out of range is a
  device-side assert, so the port scatters into tables one column wider
  and sends every dropped robot to that spare column, which is sliced
  away; no index is clamped onto a real entry.
- A robot's rank in its bucket decides which robot an over-full cell
  drops, so the ranks come from a stable sort, as `jnp.argsort(...,
  stable=True)` gives them.
- `grid_overflow` counts the robots ranked past the capacity (the same
  number as the JAX package's per-cell counts less the capacity), without
  a scatter-add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (hashable)."""

    cell_size: float
    nx: int                 # cells along x (world width + margin rings)
    ny: int
    reach: int              # stencil half-width in cells
    capacity: int           # max robots recorded per cell
    origin_x: float         # world coordinate of cell (0, 0)'s min corner
    origin_y: float

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @property
    def stencil(self) -> int:
        return (2 * self.reach + 1) ** 2

    @property
    def n_candidates(self) -> int:
        return self.stencil * self.capacity


def make_grid_spec(
    world: tuple[float, float], cell_size: float, search_radius: float, capacity: int,
) -> GridSpec:
    """The static spec: margin rings of `reach` cells on every side, so
    robots up to reach cells outside the world still resolve exactly."""
    reach = max(1, int(math.ceil(search_radius / cell_size)))
    return GridSpec(
        cell_size=float(cell_size),
        nx=int(math.ceil(world[0] / cell_size)) + 2 * reach,
        ny=int(math.ceil(world[1] / cell_size)) + 2 * reach,
        reach=reach,
        capacity=int(capacity),
        origin_x=-world[0] / 2.0 - reach * cell_size,
        origin_y=-world[1] / 2.0 - reach * cell_size,
    )


def cell_ids(spec: GridSpec, pos: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """[R] int32 cell id per robot; inactive robots park in the virtual cell
    `n_cells`, so they never appear in a bucket."""
    cx = torch.floor((pos[:, 0] - spec.origin_x) / spec.cell_size).to(torch.int32)
    cy = torch.floor((pos[:, 1] - spec.origin_y) / spec.cell_size).to(torch.int32)
    cx = cx.clamp(0, spec.nx - 1)
    cy = cy.clamp(0, spec.ny - 1)
    cid = cy * spec.nx + cx
    return torch.where(active, cid, torch.full_like(cid, spec.n_cells))


def _bucket_order(cell: torch.Tensor):
    """(order, sorted_cell, rank): robot ids grouped by cell by a stable
    sort, and each robot's rank within its cell."""
    R = cell.shape[0]
    sorted_cell, order = torch.sort(cell, stable=True)
    # first occurrence of each cell value: searchsorted against itself
    starts = torch.searchsorted(sorted_cell, sorted_cell, side="left")
    rank = torch.arange(R, dtype=torch.int32, device=cell.device) - starts.to(torch.int32)
    return order, sorted_cell, rank


def _scatter_buckets(spec: GridSpec, sorted_cell, rank, values: torch.Tensor, fill):
    """A [n_cells, C, ...] table holding `values` (in bucket order) at
    (sorted_cell, rank) and `fill` elsewhere. The JAX scatter drops robots
    ranked past C; here they land in a spare column C that is sliced off,
    as the parked cell's row n_cells is."""
    C = spec.capacity
    col = torch.where(rank < C, rank, torch.full_like(rank, C)).long()
    flat = sorted_cell.long() * (C + 1) + col
    table = torch.full(
        ((spec.n_cells + 1) * (C + 1),) + values.shape[1:], fill,
        dtype=values.dtype, device=values.device,
    )
    table[flat] = values
    return table.view((spec.n_cells + 1, C + 1) + values.shape[1:])[: spec.n_cells, :C]


def build_grid(spec: GridSpec, pos: torch.Tensor, active: torch.Tensor):
    """(cell [R], bucket [n_cells, C] of robot ids, -1 empty)."""
    cell = cell_ids(spec, pos, active)
    order, sorted_cell, rank = _bucket_order(cell)
    return cell, _scatter_buckets(spec, sorted_cell, rank, order.to(torch.int32), -1)


def build_grid_tables(
    spec: GridSpec, pos: torch.Tensor, active: torch.Tensor, radius: torch.Tensor
):
    """The bucket tables with the robots' data beside their ids: (bucket
    [n_cells, C] ids, bucket_pos [n_cells, C, 2], bucket_rad [n_cells, C]).
    Empty entries hold id -1, position 1e30 and radius 0, so the distance
    tests on them fail by themselves."""
    cell = cell_ids(spec, pos, active)
    order, sorted_cell, rank = _bucket_order(cell)
    bucket = _scatter_buckets(spec, sorted_cell, rank, order.to(torch.int32), -1)
    bpos = _scatter_buckets(spec, sorted_cell, rank, pos[order], 1e30)
    brad = _scatter_buckets(spec, sorted_cell, rank, radius[order], 0.0)
    return bucket, bpos, brad


def grid_overflow(spec: GridSpec, pos: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Number of robots dropped from over-full cells ([] int64): those
    ranked at or past the capacity in a real cell."""
    cell = cell_ids(spec, pos, active)
    _, sorted_cell, rank = _bucket_order(cell)
    return ((rank >= spec.capacity) & (sorted_cell < spec.n_cells)).sum()


def _stencil_cells(spec: GridSpec, cell: torch.Tensor):
    """Stencil cell ids per robot: (ncid [R, S] int64, valid_cell [R, S])."""
    cx = cell % spec.nx
    cy = cell // spec.nx
    span = torch.arange(-spec.reach, spec.reach + 1, dtype=torch.int32, device=cell.device)
    ody = span.repeat_interleave(2 * spec.reach + 1)   # row-major over (dy, dx)
    odx = span.repeat(2 * spec.reach + 1)
    ncx = cx[:, None] + odx[None, :]
    ncy = cy[:, None] + ody[None, :]
    valid_cell = (ncx >= 0) & (ncx < spec.nx) & (ncy >= 0) & (ncy < spec.ny)
    ncid = ncy.clamp(0, spec.ny - 1) * spec.nx + ncx.clamp(0, spec.nx - 1)
    return ncid.long(), valid_cell


def _candidate_ids(spec, cell, bucket, active, row_ids, ncid, valid_cell):
    R = cell.shape[0]
    cand = torch.where(valid_cell[..., None], bucket[ncid], -1).reshape(R, -1)   # [R, M]
    me = (torch.arange(R, dtype=torch.int32, device=cell.device) if row_ids is None
          else row_ids)[:, None]
    mask = (cand >= 0) & (cand != me) & active[:, None]
    return torch.where(mask, cand, -1), mask


def candidate_neighbours(
    spec: GridSpec,
    cell: torch.Tensor,     # [R] (local rows when sharded)
    bucket: torch.Tensor,   # [n_cells, C], global
    active: torch.Tensor,   # [R]
    row_ids: torch.Tensor | None = None,   # [R] global ids of the rows; None = arange
):
    """(cand_idx [R, M] int32, -1 invalid, cand_mask [R, M]): the ids of all
    robots bucketed in each robot's stencil, the self pair masked out.
    Stencil cells off the grid are masked, not clamped, so no candidate
    appears twice."""
    ncid, valid_cell = _stencil_cells(spec, cell)
    return _candidate_ids(spec, cell, bucket, active, row_ids, ncid, valid_cell)


def candidate_data(
    spec: GridSpec,
    cell: torch.Tensor,     # [R] (local rows when sharded)
    bucket: torch.Tensor,   # [n_cells, C] ids, global
    bpos: torch.Tensor,     # [n_cells, C, 2] positions, global
    brad: torch.Tensor,     # [n_cells, C] radii, global
    active: torch.Tensor,   # [R]
    row_ids: torch.Tensor | None = None,
):
    """The candidates with their data, all gathered by the same [R, S]
    stencil rows: (cand_idx [R, M], cand_pos [R, M, 2], cand_rad [R, M],
    cand_mask [R, M]). Invalid ids are -1; positions and radii are the
    bucket tables' rows as they are (1e30 and 0 where a bucket is empty; an
    off-grid stencil cell reads its clamped neighbour's, as in JAX, and its
    id is masked)."""
    ncid, valid_cell = _stencil_cells(spec, cell)
    R = cell.shape[0]
    cand, mask = _candidate_ids(spec, cell, bucket, active, row_ids, ncid, valid_cell)
    return cand, bpos[ncid].reshape(R, -1, 2), brad[ncid].reshape(R, -1), mask

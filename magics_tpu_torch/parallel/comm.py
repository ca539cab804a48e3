"""The communication backend of the tick (counterpart of magics_tpu's
parallel/comm.py).

Every cross-robot access in the tick (neighbour discovery, inter-robot
message delivery, column sums of pairwise event matrices) goes through a
`Comm`:

  * `LocalComm` — one address space: every robot-major tensor is already
    global, gathers are plain indexing and reductions are no-ops.
  * `ShardComm` — one rank of a `torch.distributed` process group over the
    robot axis: each rank holds `n_local` robots, robot r on rank
    r // n_local at local row r % n_local (the tiled `all_gather` order of
    the JAX `ShardComm`). `all_robots` is `all_gather_into_tensor`, `psum`
    an `all_reduce` of a copy, `scatter_rows` an `all_reduce` followed by
    `take_rows`. Neighbour ids stay global robot ids, so the tick's code is
    the same on both.

`CountingComm` wraps either and tallies the bytes each collective returns,
by call site (bench/multichip_cost.py, parallel/launch.py).

Why all-gather and not a halo exchange: robots are sharded by id, not by
position (they move), so a rank's neighbours can live on any rank.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """Single address space: tensors are already global."""

    def all_robots(self, arr: torch.Tensor) -> torch.Tensor:
        """Global view of a robot-major (leading axis = robots) tensor."""
        return arr

    def row_ids(self, n_local: int, device=None) -> torch.Tensor:
        """Global robot ids of the local rows."""
        return torch.arange(n_local, dtype=torch.int32, device=device)

    def row_offset(self) -> int:
        """Global robot id of the first local row."""
        return 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a (replicated-output) value over shards."""
        return x

    def scatter_rows(self, arr: torch.Tensor) -> torch.Tensor:
        """Reduce a per-global-robot partial sum across shards and keep the
        local rows. Local: identity."""
        return arr

    def take_rows(self, arr: torch.Tensor, n_local: int) -> torch.Tensor:
        """Slice the local rows out of a [R_total, ...] tensor."""
        return arr


@dataclasses.dataclass(frozen=True)
class ShardComm:
    """One rank of a `torch.distributed` group over the robot axis.

    `n_shards * n_local == R_total`; robot r lives on rank r // n_local at
    local row r % n_local. `group` is the process group (None: the default
    one). Nothing is caught: a failed collective raises where it is called.
    `psum` and `scatter_rows` reduce a copy, never their argument."""

    n_shards: int
    n_local: int  # robots per rank (uniform)
    rank: int
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def of_group(cls, n_robots: int, group=None) -> "ShardComm":
        """The comm of this process's rank in `group` for `n_robots` robots;
        raises where they do not divide over the ranks."""
        n = dist.get_world_size(group)
        if n_robots % n:
            raise ValueError(
                f"robot capacity {n_robots} must divide the {n} ranks "
                "(pad `capacity` in the builder)"
            )
        return cls(n_shards=n, n_local=n_robots // n, rank=dist.get_rank(group), group=group)

    def all_robots(self, arr: torch.Tensor) -> torch.Tensor:
        arr = arr.contiguous()
        out = arr.new_empty((self.n_shards * arr.shape[0], *arr.shape[1:]))
        dist.all_gather_into_tensor(out, arr, group=self.group)
        return out

    def row_ids(self, n_local: int, device=None) -> torch.Tensor:
        off = self.row_offset()
        return torch.arange(off, off + n_local, dtype=torch.int32, device=device)

    def row_offset(self) -> int:
        return self.rank * self.n_local

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def scatter_rows(self, arr: torch.Tensor) -> torch.Tensor:
        # all_reduce, then the local rows: exact for the integer counts the
        # tick scatters, and the same call on every backend
        return self.take_rows(self.psum(arr), self.n_local)

    def take_rows(self, arr: torch.Tensor, n_local: int) -> torch.Tensor:
        off = self.row_offset()
        return arr[off:off + n_local]


class CountingComm:
    """A comm that forwards every call to `inner` and tallies, for each
    collective call, the bytes of its output (what the all_gather or
    all_reduce returns, as the JAX tool counts HLO output bytes), keyed by
    (call site, op, dtype, shape) in `bytes`. A `LocalComm`
    inside moves nothing, and nothing is counted."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.bytes: dict[tuple, int] = defaultdict(int)

    def reset(self) -> None:
        self.bytes.clear()

    def _count(self, op: str, out: torch.Tensor) -> torch.Tensor:
        if isinstance(self.inner, ShardComm):
            frame = sys._getframe(2)
            code = frame.f_code
            site = f"{code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno} {code.co_name}"
            key = (site, op, str(out.dtype).removeprefix("torch."), tuple(out.shape))
            self.bytes[key] += out.numel() * out.element_size()
        return out

    def all_robots(self, arr):
        return self._count("all_gather", self.inner.all_robots(arr))

    def psum(self, x):
        return self._count("all_reduce", self.inner.psum(x))

    def scatter_rows(self, arr):
        # the all_reduce's output is the whole [R_total] sum
        self._count("all_reduce", arr)
        return self.inner.scatter_rows(arr)

    def __getattr__(self, name):
        # row_ids, row_offset, take_rows, n_local, ...: the inner comm's
        return getattr(self.inner, name)

    def by_site(self) -> dict[str, int]:
        """Bytes by call site and op, summed over dtypes and shapes."""
        out: dict[str, int] = defaultdict(int)
        for (site, op, _, _), b in self.bytes.items():
            out[f"{site} {op}"] += b
        return dict(out)


LOCAL = LocalComm()

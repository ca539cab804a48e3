"""Row gather of a contiguous table by index: the hand-written CUDA kernel
(csrc/layout.cu), its plain PyTorch version and the wrapper.

Counterpart of magics_tpu's kernels/layout.py (`layout_pin`, a Pallas
identity copy that pins XLA's row-major layout around the row gathers of
the inter-robot exchanges on the TPU). A CUDA tensor has no layout to pin,
so the port's kernel is the gather those call sites make:

    out[m, :] = table[idx[m], :], and where mask[m] is false old[m, :]
    (0 without an old table).

It serves every call site of `layout_pin`, all through
`exchange.gather_rows_pinned` (graph/exchange.py): the sender's delivery
(`exchange.gather_from_peer`) and response gather (the sender's
`deliver_responses`) and the receiver exchanges' table gathers, whatever
`use_pallas` says (on the TPU the pin runs on every run too). The callers
clip the indexes, as the JAX call sites do. The sender's two gathers pass
the old inbox and the old response positions as `old`, so that the select
that keeps them where nothing was delivered runs in the same launch.

On CUDA tensors the wrapper checks device, dtype, shape and contiguity
(`_check`, cheap tests first), allocates a fresh output, launches the
kernel on the current stream and adds one to `launch_counts`; it raises on
anything the kernel does not take and on a failed launch. On CPU tensors
it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from magics_tpu_torch.kernels.build import current_stream

#: kernel launches since the last `reset_launch_counts()`
launch_counts = {"gather_rows": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def gather_rows_reference(
    table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor | None = None,
    old: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version: `table.index_select(0, idx)`, zeroed where
    `mask` is false, or `torch.where(mask, index_select, old)` with `old`."""
    out = table.index_select(0, idx)
    if mask is not None:
        out = torch.where(mask[:, None], out, torch.zeros_like(out) if old is None else old)
    return out


_LIB: ctypes.CDLL | None = None
_GATHER = None   # the bound gather_rows entry point of _LIB


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB, _GATHER
    if _LIB is None:
        from magics_tpu_torch.kernels.build import load

        lib = load("layout")
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.gather_rows.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
        lib.gather_rows.restype = ctypes.c_int
        lib.gather_rows_word_bytes.argtypes = [ptr, ptr, ptr, i64]
        lib.gather_rows_word_bytes.restype = ctypes.c_int
        _GATHER = lib.gather_rows
        _LIB = lib
    return _LIB


def _check(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor | None,
           old: torch.Tensor | None) -> bool:
    """True where the kernel takes these tensors as they are (on the card),
    False where they lie on the CPU; raise on anything the gather does not
    take. A call the kernel takes returns at the first test, which reads
    only cached tensor attributes: the wrapper runs 20 times a tick."""
    dev = table.get_device()
    if (dev >= 0 and table.ndim == 2 and table.is_contiguous()
            and idx.dtype == torch.int64 and idx.ndim == 1 and idx.is_contiguous()
            and idx.get_device() == dev
            and (mask is None or (
                mask.dtype == torch.bool and mask.ndim == 1 and mask.shape[0] == idx.shape[0]
                and mask.is_contiguous() and mask.get_device() == dev))
            and (old is None or (
                mask is not None and old.dtype == table.dtype and old.ndim == 2
                and old.shape[0] == idx.shape[0] and old.shape[1] == table.shape[1]
                and old.is_contiguous() and old.get_device() == dev))):
        return True
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D [n, m], got shape {tuple(table.shape)}")
    if idx.ndim != 1 or idx.dtype != torch.int64:
        raise TypeError(f"idx must be 1-D int64, got {idx.dtype} {tuple(idx.shape)}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != tuple(idx.shape)):
        raise TypeError(f"mask must be bool {tuple(idx.shape)}, got {mask.dtype} {tuple(mask.shape)}")
    if old is not None:
        if mask is None:
            raise ValueError("old is read where the mask is false: it needs a mask")
        want = (idx.shape[0], table.shape[1])
        if old.dtype != table.dtype or tuple(old.shape) != want:
            raise TypeError(f"old must be {table.dtype} {want}, got {old.dtype} {tuple(old.shape)}")
    for name, x in (("idx", idx), ("mask", mask), ("old", old)):
        if x is not None and x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
    if table.device.type != "cpu":
        # on the card only contiguity is left to refuse
        for name, x in (("table", table), ("idx", idx), ("mask", mask), ("old", old)):
            if x is not None and not x.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
        raise ValueError(f"no gather kernel for device {table.device}")
    return False


def gather_rows(
    table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor | None = None,
    old: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[m] = table[idx[m]] where `mask[m]` holds, else `old[m]` (0
    without `old`): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. `table` [n, m] of any dtype, `idx` [M] int64 in [0, n),
    `mask` [M] bool or None, `old` [M, m] of the table's dtype or None (it
    needs a mask); returns a fresh [M, m] tensor."""
    if not _check(table, idx, mask, old):
        return gather_rows_reference(table, idx, mask, old)
    out = table.new_empty((idx.shape[0], table.shape[1]))
    if out.numel() == 0:
        return out
    if _GATHER is None:
        _lib()
    rc = _GATHER(
        table.data_ptr(), idx.data_ptr(), None if mask is None else mask.data_ptr(),
        None if old is None else old.data_ptr(), out.data_ptr(), idx.shape[0],
        table.shape[1] * table.element_size(),
        current_stream(table.get_device()),
    )
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {rc}")
    launch_counts["gather_rows"] += 1
    return out


def word_bytes(table: torch.Tensor, out: torch.Tensor, old: torch.Tensor | None = None) -> int:
    """The word size in bytes the kernel copies `table`'s rows (and
    `old`'s) into `out` with: 16 where the row starts and the row size allow
    it, else less. The card tests read it to check which copy path a shape
    takes."""
    return _lib().gather_rows_word_bytes(
        table.data_ptr(), None if old is None else old.data_ptr(), out.data_ptr(),
        table.shape[1] * table.element_size(),
    )

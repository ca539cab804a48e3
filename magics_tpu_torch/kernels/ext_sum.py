"""The external sums: the hand-written CUDA kernel (csrc/ext_sum.cu), its
plain PyTorch version and the wrapper.

The slot kernels read the sum over neighbour slots of each robot's external
inbox as hot planes: `ext_sum_eta` [4, V, R] and `ext_sum_lam` [4, 4, V, R].
The inbox `ext_inbox` [R, K, V-1, 4] holds compact rank-1 messages
(gx, gy, t, s) to variables 1..V-1; summed, they fill the 2x2 position
block of each variable's information vector and precision, and variable
0's planes are zero. No TPU kernel computes this: magics_tpu's
kernels/hot.py:_ext_sum_hot leaves it to XLA, and the plain version here is
the same `rank1_sum`, `pad_vars` and `hot`. The kernel sums over k in the
order PyTorch's CUDA reduction takes the plain version's sums (four
interleaved partial sums; csrc/ext_sum.cu says why): below 64 slots its
planes are the plain version's bits on the card.

On CUDA tensors `ext_sum_hot` checks device, dtype, shape, contiguity and
alignment, allocates fresh planes, launches the kernel on the current
stream and adds one to `launch_counts`; it raises on anything the kernel
does not take and on a failed launch. On CPU tensors it runs the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from magics_tpu_torch.graph.factors import rank1_sum
from magics_tpu_torch.graph.variables import pad_vars
from magics_tpu_torch.kernels.build import current_stream
from magics_tpu_torch.kernels.gbp_slot import hot

#: kernel launches since the last `reset_launch_counts()`
launch_counts = {"ext_sum": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def ext_sum_hot_reference(ext_inbox: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the inbox [R, K, V1, 4] summed over K
    (`rank1_sum`), variable 0 padded in, lifted to hot layout. Returns
    (eta [4, V, R], lam [4, 4, V, R])."""
    eta, lam = rank1_sum(ext_inbox, dim=1)  # [R, V1, 4], [R, V1, 4, 4]
    return hot(pad_vars(eta, 1, 0)), hot(pad_vars(lam, 1, 0))


def sum_tolerance(ext_inbox: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """How far two versions of the sums may part by roundoff alone, per
    entry of (eta, lam): 4 K u times the sum over k of the term's size,
    u = 2^-24 in float32 (each product rounds once or twice, and each
    version sums over k in its own order: the kernel as PyTorch's CUDA
    reduction does for K < 64, PyTorch on the CPU and XLA in theirs).
    Float64."""
    K = ext_inbox.shape[1]
    u = torch.finfo(ext_inbox.dtype).eps / 2
    eta, lam = ext_sum_hot_reference(ext_inbox.double().abs())
    return 4 * K * u * eta, 4 * K * u * lam


_LIB: ctypes.CDLL | None = None
_SUMS = None         # the bound ext_sum_hot entry point of _LIB


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB, _SUMS
    if _LIB is None:
        from magics_tpu_torch.kernels.build import load

        lib = load("ext_sum")
        ptr, i64, c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ext_sum_hot.argtypes = [ptr, ptr, ptr, i64, c_int, c_int, ptr]
        lib.ext_sum_hot.restype = c_int
        _SUMS = lib.ext_sum_hot
        _LIB = lib
    return _LIB


def _check(ext_inbox: torch.Tensor) -> bool:
    """True where the kernel takes the inbox as it is (on the card), False
    where it lies on the CPU; raise on anything the kernel does not take."""
    x = ext_inbox
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no external-sum kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"ext_inbox is {x.dtype}; the kernel takes torch.float32")
    if x.ndim != 4 or x.shape[-1] != 4:
        raise ValueError(f"ext_inbox must be [R, K, V-1, 4], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("ext_inbox is not contiguous")
    if x.data_ptr() % 16:
        raise ValueError("ext_inbox is not 16-byte aligned")
    return True


def ext_sum_hot(ext_inbox: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The external sums of `ext_inbox` [R, K, V1, 4] as fresh hot planes
    (eta [4, V1 + 1, R], lam [4, 4, V1 + 1, R]): the CUDA kernel on CUDA
    tensors (float32), the plain version on CPU tensors."""
    if not _check(ext_inbox):
        return ext_sum_hot_reference(ext_inbox)
    R, K, V1, _ = ext_inbox.shape
    eta = ext_inbox.new_empty((4, V1 + 1, R))
    lam = ext_inbox.new_empty((4, 4, V1 + 1, R))
    if ext_inbox.numel() == 0:
        return eta.zero_(), lam.zero_()
    dev = ext_inbox.get_device()
    if _SUMS is None:
        _lib()
    rc = _SUMS(ext_inbox.data_ptr(), eta.data_ptr(), lam.data_ptr(), R, K, V1,
               current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"ext_sum kernel launch failed: cudaError {rc}")
    launch_counts["ext_sum"] += 1
    return eta, lam

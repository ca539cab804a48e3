"""The receiver-computes compact exchange of one external slot: the
hand-written CUDA kernels (csrc/compact_exchange.cu), their plain PyTorch
versions and the wrappers.

No TPU kernel computes this: magics_tpu's graph/factors.py
`compact_snap_tables` and `interrobot_rank1_messages_compact` are XLA
there, and the plain versions here call the port's copies of them
(graph/factors.py). Two launches a slot:

- `compact_tables`: each robot's compact cavity table [R, V-1, 8] from its
  snapshot (the row-scaled cofactor inverse, its checks, mc and S), and
  its send gate and factor-pass counter. On a `ShardComm` the table is
  what `comm.all_robots` gathers.
- `compact_messages`: every row of a fresh inbox [R, K, V-1, 4]: the
  Sherman-Morrison message from the peer's (gathered) table row where the
  slot is delivered, the old row elsewhere.

The kernels follow the plain versions' float order (csrc/compact_exchange.cu
says how), so on the card they give the plain versions' bits.

Each wrapper checks every input's dtype and shape (the floats all of one
dtype, the flags bool, the indexes int32) on any device. On CUDA tensors
it also checks device, float32, contiguity and alignment, allocates fresh
outputs, launches its kernel on the current stream and adds one to
`launch_counts`; it raises on anything the kernel does not take and on a
failed launch, and never falls back. On CPU tensors it runs the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.kernels.build import current_stream

#: kernel launches since the last `reset_launch_counts()`
launch_counts = {"compact_table": 0, "compact_message": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def receiver_terms(src: torch.Tensor, nbr_back: torch.Tensor, radius_all: torch.Tensor,
                   safety_multiplier: float, V1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The receiver exchanges' per-factor constants [R, K, V1], from the
    peers' clipped global ids `src` [R, K] (int64) and the reciprocal slots:
    the tiny offset, fixed by the slot's position on the peer (1e-6 (((j K
    V1) + back V1) + i + 1)), and the peer's safety distance."""
    R, K = src.shape
    f = radius_all.dtype
    iota_v = torch.arange(V1, dtype=f, device=src.device)
    tiny = 1e-6 * (src.to(f)[..., None] * (K * V1) + nbr_back.to(f)[..., None] * V1
                   + iota_v + 1.0)
    safety = (safety_multiplier * radius_all[src])[..., None].expand(R, K, V1)
    return tiny, safety


def compact_tables_reference(
    snap_mu: torch.Tensor,         # [R, V, 4]
    snap_eta: torch.Tensor,        # [R, V, 4]
    snap_lam: torch.Tensor,        # [R, V, 4, 4]
    active: torch.Tensor,          # [R] bool
    antenna: torch.Tensor,         # [R] bool
    mission_active: torch.Tensor,  # [R] bool
    completed: torch.Tensor,       # [R] bool
    iter_count: torch.Tensor,      # [R] int32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: (the tables [R, V-1, 8] of
    `factors.compact_snap_tables`, the send gate [R], the counter plus the
    gate)."""
    tables = F.compact_snap_tables(snap_mu, snap_eta, snap_lam, dtype=snap_mu.dtype)
    gate = active & antenna & (mission_active | completed)
    return tables, gate, iter_count + gate.to(torch.int32)


def compact_messages_reference(
    tables_all: torch.Tensor,    # [R_all, V1, 8]
    gate: torch.Tensor,          # [R] bool, the robot's own send gate
    gate_all: torch.Tensor,      # [R_all] bool
    radius_all: torch.Tensor,    # [R_all]
    nbr_idx: torch.Tensor,       # [R, K] int32, global ids
    nbr_back: torch.Tensor,      # [R, K] int32
    nbr_mask: torch.Tensor,      # [R, K] bool
    nbr_has_back: torch.Tensor,  # [R, K] bool
    seeded: torch.Tensor,        # [R, K, V1] bool
    p_ext: torch.Tensor,         # [R, K, V1, 2]
    ext_inbox: torch.Tensor,     # [R, K, V1, 4]
    safety_multiplier: float,
    sigma: float,
) -> torch.Tensor:
    """The plain version: the peers' table rows gathered, the receiver
    terms, `factors.interrobot_rank1_messages_compact`, and the new inbox
    [R, K, V1, 4] where the slot is delivered (both robots send, the slot
    is live and reciprocal), the old one elsewhere."""
    R, K = nbr_idx.shape
    V1 = tables_all.shape[1]
    src = nbr_idx.clamp(0, tables_all.shape[0] - 1).long()
    peer = tables_all[src]                                   # [R, K, V1, 8]
    tiny, safety = receiver_terms(src, nbr_back, radius_all, safety_multiplier, V1)
    msg = F.interrobot_rank1_messages_compact(
        peer, seeded, p_ext, safety, tiny, sigma, dtype=tables_all.dtype)
    deliver = gate[:, None] & nbr_mask & gate_all[src] & nbr_has_back
    return torch.where(deliver[..., None, None], msg, ext_inbox)


_LIB: ctypes.CDLL | None = None
_TABLES = None     # the bound compact_tables entry point of _LIB
_MESSAGES = None   # the bound compact_messages entry point of _LIB


def _lib() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB, _TABLES, _MESSAGES
    if _LIB is None:
        from magics_tpu_torch.kernels.build import load

        lib = load("compact_exchange")
        ptr, i64, c_int, c_float = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.compact_tables.argtypes = [ptr] * 11 + [i64, c_int, ptr]
        lib.compact_tables.restype = c_int
        lib.compact_messages.argtypes = [ptr] * 12 + [i64, i64, c_int, c_int] + [c_float] * 3 + [ptr]
        lib.compact_messages.restype = c_int
        _TABLES, _MESSAGES = lib.compact_tables, lib.compact_messages
        _LIB = lib
    return _LIB


#: the kernels read these in 8-, 16- or 32-byte words
_ALIGN = {"snap_mu": 8, "snap_eta": 16, "snap_lam": 16, "tables_all": 32, "p_ext": 8,
          "ext_inbox": 16}


def _check(fields, card: torch.device | None) -> None:
    """Raise on any (name, tensor, dtype, shape) of `fields` whose dtype or
    shape is not the one given, on any device; for the kernels on `card`
    (None: the plain version runs) also on one off that device, not
    contiguous or not aligned for the kernel's loads."""
    for name, x, dtype, shape in fields:
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if card is None:
            continue
        if x.device != card:
            raise ValueError(f"{name} is on {x.device}, expected {card}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if x.data_ptr() % _ALIGN.get(name, 1):
            raise ValueError(f"{name} is not {_ALIGN[name]}-byte aligned")


def _card(x: torch.Tensor) -> torch.device | None:
    """x's device where the kernels run there (float32 only), None on the
    CPU, where the plain versions run; raises elsewhere."""
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"no compact-exchange kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{x.dtype} on {x.device}; the kernels take torch.float32")
    return x.device


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launch_counts[name] += 1


def compact_tables(snap_mu, snap_eta, snap_lam, active, antenna, mission_active, completed,
                   iter_count) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tables [R, V-1, 8], send gate [R] bool, counter [R] int32) of the
    snapshots [R, V, ...] and the robots' flags: the CUDA kernel on CUDA
    tensors (float32), the plain version on CPU tensors. Arguments as for
    `compact_tables_reference`."""
    args = (snap_mu, snap_eta, snap_lam, active, antenna, mission_active, completed, iter_count)
    R, V = snap_mu.shape[:2]
    f, b = snap_mu.dtype, torch.bool
    card = _card(snap_mu)
    _check((("snap_mu", snap_mu, f, (R, V, 4)), ("snap_eta", snap_eta, f, (R, V, 4)),
            ("snap_lam", snap_lam, f, (R, V, 4, 4)), ("active", active, b, (R,)),
            ("antenna", antenna, b, (R,)), ("mission_active", mission_active, b, (R,)),
            ("completed", completed, b, (R,)), ("iter_count", iter_count, torch.int32, (R,))),
           card)
    if V < 2:
        raise ValueError(f"the tables need V >= 2 variables, got {V}")
    if card is None:
        return compact_tables_reference(*args)
    tables = snap_mu.new_empty((R, V - 1, 8))
    gate = torch.empty((R,), dtype=b, device=card)
    count = torch.empty_like(iter_count)
    if R == 0:
        return tables, gate, count
    if _TABLES is None:
        _lib()
    rc = _TABLES(*(x.data_ptr() for x in args), tables.data_ptr(), gate.data_ptr(),
                 count.data_ptr(), R, V, current_stream(card.index))
    _launched(rc, "compact_table")
    return tables, gate, count


def compact_messages(tables_all, gate, gate_all, radius_all, nbr_idx, nbr_back, nbr_mask,
                     nbr_has_back, seeded, p_ext, ext_inbox, safety_multiplier: float,
                     sigma: float) -> torch.Tensor:
    """The new inbox [R, K, V1, 4]: the CUDA kernel on CUDA tensors
    (float32), the plain version on CPU tensors. Arguments as for
    `compact_messages_reference`."""
    args = (tables_all, gate, gate_all, radius_all, nbr_idx, nbr_back, nbr_mask, nbr_has_back,
            seeded, p_ext, ext_inbox)
    R, K, V1 = seeded.shape
    R_all = tables_all.shape[0]
    f, b, i32 = ext_inbox.dtype, torch.bool, torch.int32
    card = _card(ext_inbox)
    _check((("tables_all", tables_all, f, (R_all, V1, 8)), ("gate", gate, b, (R,)),
            ("gate_all", gate_all, b, (R_all,)), ("radius_all", radius_all, f, (R_all,)),
            ("nbr_idx", nbr_idx, i32, (R, K)), ("nbr_back", nbr_back, i32, (R, K)),
            ("nbr_mask", nbr_mask, b, (R, K)), ("nbr_has_back", nbr_has_back, b, (R, K)),
            ("seeded", seeded, b, (R, K, V1)), ("p_ext", p_ext, f, (R, K, V1, 2)),
            ("ext_inbox", ext_inbox, f, (R, K, V1, 4))), card)
    if R_all == 0 and R * K * V1:
        raise ValueError("no peer tables: tables_all is empty")
    if card is None:
        return compact_messages_reference(*args, safety_multiplier, sigma)
    out = torch.empty_like(ext_inbox)
    if out.numel() == 0:
        return out
    if _MESSAGES is None:
        _lib()
    # the constants as the plain version rounds them: Python doubles,
    # rounded to float where they meet a float32 tensor
    alpha = 1.0 / (sigma * sigma)
    rtol = 1e-4
    rc = _MESSAGES(*(x.data_ptr() for x in args), out.data_ptr(), R, R_all, K, V1,
                   safety_multiplier, alpha, rtol * alpha, current_stream(card.index))
    _launched(rc, "compact_message")
    return out

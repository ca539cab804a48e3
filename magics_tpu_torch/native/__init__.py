"""Native (C++) runtime components, compiled on demand and bound via ctypes.

The reference keeps its planner runtime native (Rust crates); here the
host-side pieces that sit outside the XLA compute path — currently the RRT*
global planner (crates/gbp_global_planner) — are C++ translation units
compiled by the local g++ once per checkout into `_build/` next to this
package (gitignored: the library is built, never committed) and loaded with
ctypes. Import never fails: callers check `<lib> is None` and fall back to
the pure-numpy implementations, and say which one ran
(`GlobalPlanner.backend`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE / "_build"


def _build_shared(name: str, sources: list[Path]) -> Path | None:
    """Compile `sources` into `_build/lib<name>-<hash>.so` (cached)."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    tag = h.hexdigest()[:12]
    out = _BUILD / f"lib{name}-{tag}.so"
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    # built under a name of this process's own, then renamed into place:
    # processes that build at once never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-o",
        str(tmp),
        *[str(s) for s in sources],
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:  # pragma: no cover
        print(f"magics_tpu_torch.native: build of {name} failed ({e}); using fallback", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load_rrtstar():
    path = _build_shared("rrtstar", [_HERE / "rrtstar.cpp"])
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    fn = lib.magics_rrtstar_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # dist_grid
        ctypes.c_int,  # H
        ctypes.c_int,  # W
        ctypes.c_float,  # world_w
        ctypes.c_float,  # world_h
        ctypes.c_float,  # start_x
        ctypes.c_float,  # start_y
        ctypes.c_float,  # goal_x
        ctypes.c_float,  # goal_y
        ctypes.c_float,  # collision_radius
        ctypes.c_float,  # step_size
        ctypes.c_float,  # neighbourhood_radius
        ctypes.c_int64,  # max_iterations
        ctypes.c_int,  # smooth_enabled
        ctypes.c_int64,  # smooth_iterations
        ctypes.c_float,  # smooth_step
        ctypes.c_uint64,  # seed
        ctypes.POINTER(ctypes.c_float),  # out_xy
        ctypes.c_int,  # max_out
    ]
    return fn


_rrtstar_fn = None
_rrtstar_tried = False


def rrtstar_native():
    """The compiled planner entry point, or None if unavailable."""
    global _rrtstar_fn, _rrtstar_tried
    if not _rrtstar_tried:
        _rrtstar_tried = True
        _rrtstar_fn = _load_rrtstar()
    return _rrtstar_fn

"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

The sources under `csrc/` have a plain C interface, so a build is one nvcc
call of a few seconds (PyTorch's `cpp_extension.load`, which compiles
against PyTorch's headers, takes minutes). Each library is keyed by a hash
of all the sources (the `.cuh` headers included) and the flags, and lives
in `_build/` beside this file, which `.gitignore` lists; a later call in the
same checkout reuses it. `build_all` starts one nvcc per source at once.
Nothing is built or loaded when this module is imported. `current_stream`
gives the wrappers the stream a launch goes on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: the libraries, one per csrc/<name>.cu: the kernels, and graph_nodes
#: (host code that reads a graph under capture, for profiling's stage maps)
SOURCES = ("gbp_slot", "ir_slot", "layout", "ext_sum", "compact_exchange", "graph_nodes")

# --fmad=false: see the rounding note at the top of csrc/gbp_slot.cu.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc of $CUDA_HOME, else the one on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu goes, keyed by sources and flags."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile each csrc/<name>.cu that is not built yet into a shared
    library, one nvcc per source, all started together. The ptxas report
    (registers, spills) is kept in a `.log` beside each library. Waits for
    every nvcc it started, then raises if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            jobs.append((proc, cmd, tmp, lib))
    finally:
        results = [(proc.communicate(), proc.returncode, cmd, tmp, lib)
                   for proc, cmd, tmp, lib in jobs]
    failures = []
    for (out, err), rc, cmd, tmp, lib in results:
        if rc != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}{err}")
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name) for name in names}


def ptxas_report(name: str) -> str:
    """The -Xptxas -v lines of the current build of csrc/<name>.cu."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def current_stream(device_index: int) -> int:
    """The cudaStream_t (as an int) of PyTorch's current stream on card
    `device_index`, for a launch: `torch.cuda.current_stream(i).cuda_stream`
    without building a Stream object on every call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _loaded[name]

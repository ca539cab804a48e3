"""The port stands alone: no module of magics_tpu_torch, nor chip_smoke.py,
imports JAX or anything of the JAX package (an AST scan of every import
statement, and the imports run in a fresh interpreter); the port's own copies
of the framework-free core modules equal the JAX package's; and the entry
points build on the card by default, so without one they raise."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from magics_tpu.core import constants as JC
from magics_tpu.core import schedule as JS
from magics_tpu.core import timesteps as JTS
from magics_tpu_torch.core import constants as TC
from magics_tpu_torch.core import schedule as TS
from magics_tpu_torch.core import timesteps as TTS

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "magics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "magics_tpu")


def _imported(path: Path) -> set[str]:
    """Every module an import statement of `path` names (absolute imports;
    relative ones stay inside the port)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = sorted(n for n in _imported(path) if _forbidden(n))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\ndef f():\n    from magics_tpu.core.schedule import ScheduleKind\n"
                   "    import jax.numpy as jnp\n")
    assert sorted(n for n in _imported(src) if _forbidden(n)) == [
        "jax.numpy", "magics_tpu.core.schedule"]
    assert not _forbidden("magics_tpu_torch.core.schedule")


def test_imports_load_no_jax_package():
    """Every module of the port and every module chip_smoke.py names, in a
    fresh interpreter: nothing of JAX or of magics_tpu ends in sys.modules."""
    port = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES if p.name != "chip_smoke.py"
    )
    smoke = sorted(_imported(REPO / "chip_smoke.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {port + smoke!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    for module in ("magics_tpu_torch.kernels.gbp_slot", "magics_tpu_torch.graph.grid",
                   "magics_tpu_torch.graph.chunk", "magics_tpu_torch.bench.scale"):
        assert module in port, module


def test_constants_equal_jax():
    names = {n for n in dir(JC) if n.isupper()}
    assert names == {n for n in dir(TC) if n.isupper()}
    for n in names:
        assert getattr(TC, n) == getattr(JC, n), n


@pytest.mark.parametrize("kind", list(JS.ScheduleKind), ids=lambda k: k.value)
def test_schedules_equal_jax(kind):
    assert [k.value for k in TS.ScheduleKind] == [k.value for k in JS.ScheduleKind]
    pairs = [(0, 0), (1, 0), (0, 1), (3, 3), (10, 10), (50, 10), (10, 50), (7, 12), (13, 4),
             (2, 9), (64, 1), (31, 32)]
    for internal, external in pairs:
        want = JS.schedule_booleans(kind, internal, external)
        assert TS.schedule_booleans(TS.ScheduleKind(kind.value), internal, external) == want, (
            internal, external)


def test_timesteps_equal_jax():
    for horizon in range(-2, 200):
        for multiple in (1, 2, 3, 4, 7):
            want = JTS.get_variable_timesteps(horizon, multiple)
            assert TTS.get_variable_timesteps(horizon, multiple) == want, (horizon, multiple)


def test_entry_points_default_to_the_card():
    """build_scenario, init_state (through it) and state_from_numpy build on
    CUDA unless asked for the CPU: without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default builds there")
    import numpy as np

    from magics_tpu_torch import convert
    from magics_tpu_torch.sim import builder as TB

    specs = TB.circle_formation(4, circle_radius=10.0, target_speed=5.0)
    with pytest.raises(RuntimeError, match="cuda"):
        TB.build_scenario(specs, target_speed=5.0)
    params, state, _ = TB.build_scenario(specs, target_speed=5.0, device="cpu")
    assert state.device.type == "cpu" and params.use_pallas is None
    assert not params.uses_kernels(state.device)
    assert params.uses_kernels(torch.device("cuda"))
    arrays = convert.state_to_numpy(state)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.state_from_numpy(arrays)
    assert convert.state_from_numpy(arrays, device="cpu").device.type == "cpu"
    assert np.array_equal(convert.state_to_numpy(state)["pos"], arrays["pos"])

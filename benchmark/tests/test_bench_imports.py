"""No module loaded by a run has the top-level name jax, jaxlib, flax or
magics_tpu, compared whole (magics_tpu_torch begins with magics_tpu and is
the program)."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    monkeypatch.setitem(sys.modules, "magics_tpu_torch_like", types.ModuleType("x"))
    before = set(H.forbidden_modules())
    assert "jaxtyping_like" not in before and "magics_tpu_torch_like" not in before
    monkeypatch.setitem(sys.modules, "magics_tpu.sub", types.ModuleType("magics_tpu.sub"))
    assert "magics_tpu" in H.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of two cells' drivers on the CPU at a tiny size, in a
    fresh process, then every per-layer reader loaded and read and every
    driver and benchmark module loaded (the batch driver's program modules
    too, which its run imports on the card), then the look at sys.modules
    the harness makes."""
    code = textwrap.dedent(f"""
        import importlib, sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        torch.set_num_threads(2)
        from benchmark import harness as H
        from benchmark.tests.bench_cells import SMALL, small_cell
        outs = []
        for name in sorted(SMALL):
            cell = small_cell(name, SMALL[name])
            outs.append(H.driver(cell.traffic["driver"]).run(
                H.Context(cell, 5, 0.1, False, device="cpu")))
        for path in sorted((H.BENCH / "metrics").glob("*.py")):
            for out in outs:
                H.reader(path.stem).read(out)
        for path in sorted((H.BENCH / "drivers").glob("*.py")):
            H.driver(path.stem)
        for name in ("benchmark.control", "benchmark.deploy", "benchmark.messages",
                     "benchmark.rooflines", "magics_tpu_torch.graph.chunk"):
            importlib.import_module(name)
        print("FOUND", H.forbidden_modules())
        print("PROGRAM", "magics_tpu_torch" in sys.modules)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout
    assert "PROGRAM True" in res.stdout

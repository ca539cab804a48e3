"""The port's offline surfaces against the JAX package's on the CPU: the
renderers (viz/render.py) and the PNG writer that replaces Pillow
(viz/png.py), the playback player (viz/player.py), the factor-graph DOT
export (viz/graphviz.py) and the pretty-printer (core/pretty.py).

Inputs: the export of a float64 run of an 8-robot crossing with an obstacle
(tests/torch_scenarios.py), and its final state. Tolerance: none. Every
array, text and document equals the JAX package's for the same input; a PNG
the port writes decodes (by Pillow, and by the port's own reader) to the
array drawn.
"""

from __future__ import annotations

import io
import json
import math
import types

import numpy as np
import pytest
import torch
from PIL import Image
from torch_scenarios import write_scenario

from magics_tpu.core import pretty as JP
from magics_tpu.viz import graphviz as JG
from magics_tpu.viz import player as JPL
from magics_tpu.viz import render as JR
from magics_tpu_torch.config.loader import load_scenario
from magics_tpu_torch.convert import state_to_numpy
from magics_tpu_torch.core import pretty as TP
from magics_tpu_torch.env.sdf import env_to_image
from magics_tpu_torch.sim.simulator import Simulator
from magics_tpu_torch.viz import graphviz as TG
from magics_tpu_torch.viz import player as TPL
from magics_tpu_torch.viz import png
from magics_tpu_torch.viz import render as TR


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A float64 run of the crossing for 25 ticks: the Simulator, its export,
    the obstacle raster and the world size."""
    root = tmp_path_factory.mktemp("scenarios")
    scenario = load_scenario(write_scenario(root, "Crossing Lines"))
    sim = Simulator(scenario, dtype=torch.float64, device="cpu")
    sim.run(max_ticks=25, chunk_ticks=10)
    env = scenario.environment
    obstacle = env_to_image(env, expansion=0.0) == 0
    assert obstacle.any() and not obstacle.all()
    return types.SimpleNamespace(sim=sim, export=sim.export(), obstacle=obstacle,
                                 world=env.world_size, root=root)


def test_render_frame_equals_jax(run):
    kw = dict(obstacle=run.obstacle, world=run.world, comms_radius=30.0)
    for k in (0, 7, 100):
        got = TR.render_frame(run.export, k, **kw)
        np.testing.assert_array_equal(got, JR.render_frame(run.export, k, **kw))
    assert (got != np.array(TR.BASE, dtype=np.uint8)).any()


def test_render_trajectories_and_its_png_equal_jax(run, tmp_path):
    img = TR.render_trajectories(run.export, tmp_path / "port.png", obstacle=run.obstacle,
                                 world=run.world)
    want = JR.render_trajectories(run.export, tmp_path / "jax.png", obstacle=run.obstacle,
                                  world=run.world)
    np.testing.assert_array_equal(img, want)
    data = (tmp_path / "port.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(png.idat_pixels(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "jax.png")), img)


def test_record_frames_equal_jax(run, tmp_path):
    kw = dict(obstacle=run.obstacle, world=run.world, comms_radius=30.0, px_per_m=3.0)
    n = TR.record_frames(run.export, tmp_path / "port", every=4, **kw)
    samples = max(len(r["positions"]) for r in run.export["robots"].values())
    assert n == JR.record_frames(run.export, tmp_path / "jax", every=4, **kw)
    assert n == len(range(0, samples, 4)) and samples >= 20
    for i in range(n):
        name = f"frame_{i:05d}.png"
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))


@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 7, 3), (33, 17, 4)])
def test_png_writer_round_trips_through_pillow(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    data = png.encode_png(img)
    decoded = Image.open(io.BytesIO(data))
    assert decoded.mode == ("RGB" if shape[2] == 3 else "RGBA")
    np.testing.assert_array_equal(np.asarray(decoded), img)
    np.testing.assert_array_equal(png.idat_pixels(data), img)
    with pytest.raises(ValueError):
        png.encode_png(img.astype(np.float32))


def test_render_main_equals_jax(run, tmp_path, capsys):
    """`python -m ... viz.render EXPORT --scenario-dir DIR` (the world and
    raster from the scenario), and --frames."""
    path = tmp_path / "export.json"
    path.write_text(json.dumps(run.export))
    scenario = str(run.root / "Crossing Lines")
    for main, out in ((TR.main, "port"), (JR.main, "jax")):
        assert main([str(path), "--scenario-dir", scenario, "--out", str(tmp_path / f"{out}.png"),
                     "--px-per-m", "2"]) == 0
        assert main([str(path), "--frames", "--every", "10", "--out",
                     str(tmp_path / f"{out}_frames")]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    for name in ("frame_00000.png", "frame_00002.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port_frames" / name)),
                                      np.asarray(Image.open(tmp_path / "jax_frames" / name)))


def test_player_equals_jax(run, tmp_path, capsys):
    html = TPL.build_player(run.export)
    assert html == JPL.build_player(run.export)
    assert json.dumps(run.export, separators=(",", ":")) in html
    assert TPL.build_player(run.export, title="t") == JPL.build_player(run.export, title="t")
    path = tmp_path / "export.json"
    path.write_text(json.dumps(run.export))
    assert TPL.main([str(path), "-o", str(tmp_path / "p.html")]) == 0
    capsys.readouterr()
    assert (tmp_path / "p.html").read_text() == html


def test_factorgraph_dot_equals_jax(run, tmp_path):
    """The DOT of the port's state against the JAX function's over the same
    state converted to numpy, for all active robots and for a subset, with
    the obstacle and tracking factors on and off."""
    state = run.sim.state
    jstate = types.SimpleNamespace(**state_to_numpy(state))
    assert bool(state.nbr_mask.any())
    params = run.sim.params
    for p in (params, types.SimpleNamespace(obstacle_enabled=False, tracking_enabled=True)):
        for robots in (None, [0, 3, 5]):
            dot = TG.factorgraph_dot(state, p, robots)
            assert dot == JG.factorgraph_dot(jstate, p, robots)
    assert "f_ir" in TG.factorgraph_dot(state, params) and "f_t" in dot
    TG.export_dot(state, params, tmp_path / "g.dot")
    assert (tmp_path / "g.dot").read_text() == TG.factorgraph_dot(state, params)


PRETTY_INPUTS = [
    np.array([[1.5, -2.0], [0.0, 10.25]]),
    np.array([math.inf, 1.0, -math.nan, 1e5, -1e-5]),
    np.arange(12.0).reshape(3, 4) - 5.5,
]


@pytest.mark.parametrize("color", [False, True])
def test_pretty_strings_equal_jax(color):
    for x in PRETTY_INPUTS:
        for arg in (x, torch.from_numpy(x), torch.from_numpy(x).float()):
            want = x if isinstance(arg, np.ndarray) else arg.numpy()
            assert TP.format_matrix(arg, name="m", color=color) == JP.format_matrix(
                want, name="m", color=color)
            assert TP.format_vector(arg.reshape(-1), color=color) == JP.format_vector(
                want.reshape(-1), color=color)
    lam = np.array([[2.0, 0.3], [0.3, 4.0]])
    eta = lam @ np.array([1.0, -3.0])
    for a, b in ((eta, lam), (eta, np.zeros((2, 2)))):
        assert TP.format_gaussian(torch.from_numpy(a), torch.from_numpy(b), color=color) == (
            JP.format_gaussian(a, b, color=color))
    for v in (0.0, 1.0, 9.99, 10.0, -1.5, 1e5, 1e-5, math.nan, -math.inf):
        assert TP.num_of_integral_digits(v) == JP.num_of_integral_digits(v)

"""The port's live view (viz/live.py) on the CPU: its frames against the JAX
package's LiveServer for the same run, and the browser's control channel
(pause, step, set, a bad command, resume to completion) over HTTP, as
tests/test_live_control.py holds the JAX one, on a scenario written into a
temporary directory (tests/torch_scenarios.py).

Tolerances: frame times, flags and counters equal; positions within 1e-6 m
(float64 runs); the scene's obstacle PNG decodes to the JAX one's pixels.
`drive` harvests the position log once (ROADMAP F4: the JAX drive harvests
after every chunk) and a quit before the first chunk runs no tick.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_scenarios import write_scenario

from magics_tpu.config.loader import load_scenario as jload
from magics_tpu.sim.simulator import Simulator as JSimulator
from magics_tpu.viz import live as JL
from magics_tpu_torch.config.loader import load_scenario
from magics_tpu_torch.sim.simulator import Simulator
from magics_tpu_torch.viz import live as TL


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenarios")
    write_scenario(root, "Crossing Lines")
    write_scenario(root, "Second Crossing", robots=6, seed=5, max_time=3.0, tile=60.0)
    return root


def _count_harvests(sim) -> list:
    calls = []
    harvest = sim._harvest_log

    def counted(state):
        calls.append(int(state.tick))
        harvest(state)

    sim._harvest_log = counted
    return calls


def _frames(live) -> list[dict]:
    return [json.loads(f) for f in live.frames_since(0)[1]]


def _scene_pixels(scene: str):
    scene = json.loads(scene)
    png = base64.b64decode(scene.pop("obstacle_png"))
    return scene, np.asarray(Image.open(io.BytesIO(png)))


def test_drive_frames_equal_jax(root):
    """`drive` in 5-tick chunks to the scenario's end in both packages:
    the same frames (one before the run, one a chunk), summary and scene."""
    path = root / "Crossing Lines"
    jsim = JSimulator(jload(path), dtype=jnp.float64)
    tsim = Simulator(load_scenario(path), dtype=torch.float64, device="cpu")
    jlive, tlive = JL.LiveServer(jsim, port=0), TL.LiveServer(tsim, port=0)
    jlive.push(jsim.state)
    tlive.push(tsim.state)
    harvests = _count_harvests(tsim)
    jsum, tsum = jlive.drive(chunk_ticks=5), tlive.drive(chunk_ticks=5)
    assert tsum == jsum and tsum["ticks"] == 40
    assert harvests == [40]
    jframes, tframes = _frames(jlive), _frames(tlive)
    assert len(tframes) == len(jframes) == 1 + 40 // 5
    start = np.array(tframes[0]["pos"])
    for j, t in zip(jframes, tframes):
        jpos, tpos = np.array(j.pop("pos")), np.array(t.pop("pos"))
        assert t == j
        np.testing.assert_allclose(tpos, jpos, rtol=0, atol=1e-6)
    assert tframes[-1]["t"] == 4.0 and np.abs(tpos - start).max() > 5
    (jscene, jpix), (tscene, tpix) = _scene_pixels(jlive._scene), _scene_pixels(tlive._scene)
    assert tscene == jscene
    np.testing.assert_array_equal(tpix, jpix)
    assert (tpix[..., 3] == 255).any()


def test_quit_before_any_chunk_runs_no_tick(root):
    """A quit at tick 0 returns the zero-tick summary (the JAX drive's
    fallback ran the whole scenario, ROADMAP F4) and harvests once."""
    sim = Simulator(load_scenario(root / "Crossing Lines"), device="cpu")
    harvests = _count_harvests(sim)
    live = TL.LiveServer(sim, port=0)
    live.submit({"op": "quit"})
    summary = live.drive()
    assert summary["ticks"] == 0 and int(sim.state.tick) == 0 and harvests == [0]
    assert sim.stats.eager_chunks == 0


def test_rebind_serves_the_new_scenario(root):
    """The REPL's `load` with --serve: the scene is the new scenario's and
    the frames start again from its state."""
    first = Simulator(load_scenario(root / "Crossing Lines"), device="cpu")
    second = Simulator(load_scenario(root / "Second Crossing"), device="cpu")
    live = TL.LiveServer(first, port=0)
    live.push(first.state)
    live.rebind(second)
    seq, frames = live.frames_since(0)
    assert seq == 2 and len(frames) == 1 and len(json.loads(frames[0])["pos"]) == 6
    scene = json.loads(live._scene)
    assert scene["title"] == "Second Crossing" and scene["robots"] == 6
    assert live._scene == TL.LiveServer._build_scene(second)


# ---- the control channel over HTTP (tests/test_live_control.py's) ---------


def _post(port: int, cmd: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/cmd",
                                 data=json.dumps(cmd).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


def _get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read()


@pytest.fixture(scope="module")
def served(root):
    sim = Simulator(load_scenario(root / "Crossing Lines"), max_sim_time=6.0, device="cpu")
    harvests = _count_harvests(sim)
    live = TL.LiveServer(sim, port=0)
    live.start()
    live.submit({"op": "pause"})    # the test owns virtual time from tick 0
    t = threading.Thread(target=live.drive, kwargs={"chunk_ticks": 2})
    t.start()
    yield sim, live, t, harvests
    live.submit({"op": "quit"})
    t.join(timeout=60)
    live.stop()
    assert not t.is_alive()


def _wait_tick(sim, pred, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred(int(sim.state.tick)):
            return int(sim.state.tick)
        time.sleep(0.05)
    raise AssertionError(f"timeout; tick={int(sim.state.tick)}")


def test_page_and_status_are_served(served):
    _sim, live, _t, _h = served
    assert json.loads(_get(live.port, "/status.json"))["paused"] is True
    page = _get(live.port, "/").decode()
    assert TL._LIVE_TEMPLATE == JL._LIVE_TEMPLATE and "const THEME = {" in page
    assert json.loads(_get(live.port, "/scene.json"))["robots"] == 8


def test_pause_holds_virtual_time(served):
    sim, _live, _t, _h = served
    tick0 = int(sim.state.tick)
    time.sleep(0.6)
    assert int(sim.state.tick) == tick0


def test_step_advances_exactly_n_while_paused(served):
    sim, live, _t, _h = served
    tick0 = int(sim.state.tick)
    assert _post(live.port, {"op": "step", "n": 3})["ok"]
    _wait_tick(sim, lambda t: t == tick0 + 3)
    time.sleep(0.4)  # still paused: no further advance
    assert int(sim.state.tick) == tick0 + 3
    seq, frames = live.frames_since(0)
    assert json.loads(frames[-1])["t"] == pytest.approx((tick0 + 3) * sim.dt)


def test_set_edits_params_between_chunks(served):
    sim, live, _t, _h = served
    assert _post(live.port, {"op": "set", "key": "comms-radius", "value": "33.5"})["ok"]
    _post(live.port, {"op": "step", "n": 1})
    tick0 = int(sim.state.tick)
    _wait_tick(sim, lambda t: t >= tick0)
    deadline = time.monotonic() + 10
    while sim.params.comms_radius != 33.5 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sim.params.comms_radius == 33.5


def test_bad_command_rejected(served):
    _sim, live, _t, _h = served
    assert _post(live.port, {"op": "nonsense"})["ok"] is False


def test_resume_runs_to_completion_or_cap_and_harvests_once(served):
    sim, live, thread, harvests = served
    assert _post(live.port, {"op": "resume"})["ok"]
    thread.join(timeout=120)
    assert not thread.is_alive()
    tick = int(sim.state.tick)
    assert tick >= int(sim.max_sim_time * sim.hz) or int(sim.state.completed.sum()) == len(sim.specs)
    assert harvests == [tick]
    assert sim.stats.captures == [] and sim.stats.eager_chunks > 10

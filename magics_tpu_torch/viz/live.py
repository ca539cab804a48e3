"""Live browser view of a RUNNING simulation (counterpart of magics_tpu's
viz/live.py) — the headless redesign of the reference's live Bevy/egui view
(crates/magics/src/ui/mod.rs:36-83).

The reference renders every frame from the ECS; a headless GPU run instead
streams compact per-chunk frames (positions, counters) from the device to a
tiny stdlib HTTP server, and a self-contained canvas page polls them:

    python -m magics_tpu_torch.cli -i <scenario> --interactive --serve 8008
    # browser: http://localhost:8008  — moving swarm, trails, metrics

No third-party server or websocket dependency: the page long-polls
`/live.json?since=<seq>` (~5 Hz), which answers with the frames recorded
since `seq`. Frames are pushed by the driving thread (`LiveServer.push`)
after every device chunk, one copy off the device each — the handler
thread only serves cached JSON and never touches device state.

`drive` advances the sim by `Simulator.advance`: its chunks replay the
session's one graph and a browser `step n` runs as replays of it and an
eager remainder, so no step size captures a graph of its own. It harvests
the position log once, when it ends (the JAX package harvests after every
chunk, a host loop over the whole log).
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from magics_tpu_torch.viz.player import _ROBOT_CYCLE, _THEME
from magics_tpu_torch.viz.png import encode_png


class LiveServer:
    """Serves a live view of `sim` (a sim.simulator.Simulator)."""

    def __init__(self, sim, port: int = 8008, history: int = 2400):
        self.sim = sim
        self.port = port
        self.history = history
        self._frames: list[str] = []  # JSON-encoded frames
        self._seq0 = 0                # seq of _frames[0]
        self._lock = threading.Lock()
        self._scene = self._build_scene(sim)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # control channel (browser -> sim): POST /cmd enqueues, the driving
        # thread (drive()) consumes between device chunks — the reference's
        # egui pause/play + settings panel (pause_play.rs:16-47,
        # ui/settings.rs), redesigned as an HTTP command queue so the
        # handler threads never touch device state
        self.paused = False
        self._cmds: list[dict] = []
        self._cv = threading.Condition()

    # -- scene (static) -----------------------------------------------------

    @staticmethod
    def _build_scene(sim) -> str:
        from magics_tpu_torch.env.sdf import env_to_image

        env = sim.scenario.environment
        img = env_to_image(env, expansion=0.0)  # u8: 0 obstacle, 255 free
        H, W = img.shape
        # obstacle raster -> transparent PNG (obstacles in the overlay color)
        rgba = np.zeros((H, W, 4), dtype=np.uint8)
        dark = img < 128
        rgba[dark] = [88, 91, 112, 255]  # surface2
        png64 = base64.b64encode(encode_png(rgba)).decode()

        radii = [float(s.radius) for s in sim.specs]
        return json.dumps(
            {
                "title": sim.scenario.name,
                "world": list(env.world_size),
                "obstacle_png": png64,
                "radius": radii,
                "hz": sim.hz,
                "robots": len(sim.specs),
            }
        )

    def rebind(self, sim) -> None:
        """Point the server at a NEW Simulator (the REPL's `load` scenario
        switch): rebuild the static scene, drop stale frames."""
        self.sim = sim
        self._scene = self._build_scene(sim)
        with self._lock:
            self._seq0 += len(self._frames)
            self._frames = []
        self.push(sim.state)

    # -- frames -------------------------------------------------------------

    def push(self, state) -> None:
        """Record one frame from the device state: [R, 2] positions, the
        active and completed flags and three counters, packed on the device
        and copied to the host at once. Call from the driving thread."""
        R = state.pos.shape[0]
        host = torch.cat([
            state.pos.reshape(-1).double(), state.active.double(),
            state.completed.double(),
            torch.stack([x.double() for x in (state.tick, state.rr_collisions,
                                              state.re_collisions)]),
        ]).cpu().numpy()
        tick, rr, re = (int(v) for v in host[-3:])
        frame = json.dumps(
            {
                "t": round(tick * self.sim.dt, 3),
                "pos": np.round(host[:2 * R].reshape(R, 2), 3).tolist(),
                "active": host[2 * R:3 * R].astype(int).tolist(),
                "done": int(host[3 * R:4 * R].sum()),
                "rr": rr,
                "re": re,
            },
            separators=(",", ":"),
        )
        with self._lock:
            self._frames.append(frame)
            if len(self._frames) > self.history:
                drop = len(self._frames) - self.history
                self._frames = self._frames[drop:]
                self._seq0 += drop

    def frames_since(self, seq: int) -> tuple[int, list[str]]:
        with self._lock:
            lo = max(0, seq - self._seq0)
            return self._seq0 + len(self._frames), self._frames[lo:]

    # -- control channel ----------------------------------------------------

    def submit(self, cmd: dict) -> None:
        """Enqueue one control command ({"op": "pause"|"resume"|"step"|
        "set"|"quit", ...}) and wake the driving thread."""
        with self._cv:
            self._cmds.append(cmd)
            self._cv.notify_all()

    def _wait_cmds(self, timeout: float) -> list[dict]:
        with self._cv:
            if not self._cmds:
                self._cv.wait(timeout)
            cmds, self._cmds = self._cmds, []
            return cmds

    def drive(self, chunk_ticks: int = 5, progress=None,
              checkpoint_path=None, checkpoint_every_s: float | None = None) -> dict:
        """Control-aware run loop: advances the sim in small chunks, pushing
        a frame after each, while honouring browser commands between chunks.

        Replaces the single `sim.run()` call when `--serve` runs without
        `--interactive`. Semantics mirror the reference's virtual-time
        pause/play (pause_play.rs:16-47) and manual stepping
        (robot.rs:2448-2519): `pause` freezes virtual time, `step n`
        advances n ticks while paused, `set key value` edits GbpParams with
        effect from the next chunk, `quit` ends the run. Runs on any thread:
        it makes the sim's card the thread's current device, where the
        chunk graphs are captured and replayed.
        """
        from magics_tpu_torch.sim.simulator import apply_live_set

        sim = self.sim
        if sim.device.type == "cuda":
            torch.cuda.set_device(sim.state.pos.device)
        max_ticks = int(sim.max_sim_time * sim.hz)
        last_spawn = max(s.spawn_tick for s in sim.specs)
        # periodic checkpointing is tracked here, not inside sim.run: the
        # short per-chunk run() calls each reset run()'s own interval clock
        ckpt_interval = (
            int(checkpoint_every_s * sim.hz) if checkpoint_every_s else None
        )
        last_ckpt = 0
        summary: dict | None = None
        while True:
            step_n = 0
            quit_req = False
            for cmd in self._wait_cmds(0.25 if self.paused else 0.0):
                op = cmd.get("op")
                if op == "pause":
                    self.paused = True
                elif op == "resume":
                    self.paused = False
                elif op == "step":
                    step_n += max(1, int(cmd.get("n", 1)))
                elif op == "set":
                    try:
                        apply_live_set(sim, cmd.get("key", ""), cmd.get("value"))
                    except (KeyError, ValueError, TypeError):
                        pass  # bad edits are ignored, the view shows state
                elif op == "quit":
                    quit_req = True
            if quit_req:
                break
            if self.paused and step_n == 0:
                continue
            tick = int(sim.state.tick)
            if tick >= max_ticks:
                break
            n = step_n if step_n else chunk_ticks
            summary = sim.advance(
                min(n, max_ticks - tick), chunk_ticks=chunk_ticks,
                progress=progress, on_chunk=lambda st, _t: self.push(st),
            )
            if (
                checkpoint_path is not None
                and ckpt_interval
                and summary["ticks"] - last_ckpt >= ckpt_interval
            ):
                sim.save_checkpoint(checkpoint_path)
                last_ckpt = summary["ticks"]
            if (
                not self.paused
                and summary["completed"] == summary["robots"]
                and summary["ticks"] >= last_spawn
                and (sim.mission is None or not sim.mission.active)
            ):
                break
        if summary is None:
            # never advanced (immediate quit): the zero-tick summary, which
            # also harvests
            return sim.run(max_ticks=int(sim.state.tick))
        sim._harvest_log(sim.state)
        return summary

    # -- server -------------------------------------------------------------

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/live.json"):
                    since = 0
                    if "since=" in self.path:
                        try:
                            since = int(self.path.split("since=")[1].split("&")[0])
                        except ValueError:
                            since = 0
                    seq, frames = server.frames_since(since)
                    body = (
                        '{"seq":%d,"frames":[%s]}' % (seq, ",".join(frames))
                    ).encode()
                    self._send(body, "application/json")
                elif self.path.startswith("/scene.json"):
                    self._send(server._scene.encode(), "application/json")
                elif self.path.startswith("/status.json"):
                    self._send(
                        json.dumps({"paused": server.paused}).encode(),
                        "application/json",
                    )
                else:
                    page = (
                        _LIVE_TEMPLATE
                        .replace("__THEME__", json.dumps(_THEME))
                        .replace(
                            "__CYCLE__",
                            json.dumps([_THEME[c] for c in _ROBOT_CYCLE]),
                        )
                    )
                    self._send(page.encode(), "text/html; charset=utf-8")

            def do_POST(self):  # noqa: N802
                if not self.path.startswith("/cmd"):
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    cmd = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    cmd = {}
                if cmd.get("op") in ("pause", "resume", "step", "set", "quit"):
                    server.submit(cmd)
                    self._send(b'{"ok":true}', "application/json")
                else:
                    self._send(b'{"ok":false}', "application/json")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None


_LIVE_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>magics_tpu live</title>
<style>
* { box-sizing: border-box; margin: 0; }
body { display: flex; height: 100vh; font: 13px/1.5 system-ui, sans-serif; }
#scene { flex: 1; display: block; }
#panel { width: 240px; padding: 12px; }
#panel h1 { font-size: 15px; margin-bottom: 8px; }
.kv { display: flex; justify-content: space-between; }
.kv span:last-child { font-variant-numeric: tabular-nums; }
button { margin-top: 10px; border: none; border-radius: 4px;
         padding: 4px 10px; cursor: pointer; font-weight: 600; }
#ctl { margin-top: 14px; border-top: 1px solid #0003; padding-top: 8px; }
#ctl select, #ctl input { width: 100%; margin-top: 4px; border-radius: 4px;
                          border: none; padding: 3px 6px; }
.row { display: flex; gap: 6px; }
.row button { flex: 1; }
</style></head><body>
<canvas id="scene"></canvas>
<div id="panel">
  <h1 id="title">connecting…</h1>
  <div class="kv"><span>sim time</span><span id="m-t">–</span></div>
  <div class="kv"><span>active</span><span id="m-active">–</span></div>
  <div class="kv"><span>completed</span><span id="m-done">–</span></div>
  <div class="kv"><span>robot–robot collisions</span><span id="m-rr">–</span></div>
  <div class="kv"><span>robot–environment</span><span id="m-re">–</span></div>
  <button id="pause">pause view</button>
  <div id="ctl">
    <div class="row">
      <button id="sim-pause">&#9208; pause sim</button>
      <button id="sim-step">step</button>
    </div>
    <select id="set-key">
      <option>comms-radius</option><option>comms-failure-rate</option>
      <option>sigma-factor-dynamics</option>
      <option>sigma-factor-interrobot</option>
      <option>sigma-factor-obstacle</option>
      <option>sigma-factor-tracking</option>
      <option>safety-distance-multiplier</option>
      <option>dynamic-enabled</option><option>interrobot-enabled</option>
      <option>obstacle-enabled</option><option>tracking-enabled</option>
    </select>
    <input id="set-value" placeholder="value" />
    <button id="set-apply">apply</button>
  </div>
</div>
<script>
const THEME = __THEME__, CYCLE = __CYCLE__;
document.body.style.background = THEME.base;
document.body.style.color = THEME.text;
document.getElementById("panel").style.background = THEME.mantle;
const cv = document.getElementById("scene"), cx = cv.getContext("2d");
let scene = null, frames = [], seq = 0, obsImg = null, follow = true;
const TRAIL = 60;

document.getElementById("pause").onclick = () => {
  follow = !follow;
  document.getElementById("pause").textContent =
    follow ? "pause view" : "resume view";
};

// sim control (POST /cmd -> LiveServer.drive). Available when the server
// drives the run; under --interactive the REPL owns virtual time and these
// commands are queued but unread.
let simPaused = false;
const cmd = (c) => fetch("/cmd", { method: "POST", body: JSON.stringify(c) });
const pauseBtn = document.getElementById("sim-pause");
pauseBtn.onclick = async () => {
  simPaused = !simPaused;
  await cmd({ op: simPaused ? "pause" : "resume" });
  pauseBtn.innerHTML = simPaused ? "&#9654; resume sim" : "&#9208; pause sim";
};
document.getElementById("sim-step").onclick = () => cmd({ op: "step", n: 1 });
document.getElementById("set-apply").onclick = () =>
  cmd({ op: "set", key: document.getElementById("set-key").value,
        value: document.getElementById("set-value").value });

async function boot() {
  scene = await (await fetch("/scene.json")).json();
  document.getElementById("title").textContent = scene.title;
  obsImg = new Image();
  obsImg.src = "data:image/png;base64," + scene.obstacle_png;
  poll(); requestAnimationFrame(draw);
}
async function poll() {
  try {
    const r = await (await fetch("/live.json?since=" + seq)).json();
    seq = r.seq;
    for (const f of r.frames) frames.push(f);
    if (frames.length > 4000) frames = frames.slice(frames.length - 4000);
  } catch (e) {}
  setTimeout(poll, 200);
}
function draw() {
  requestAnimationFrame(draw);
  if (!scene || frames.length === 0) return;
  if (!follow) return;
  const dpr = window.devicePixelRatio || 1;
  const w = cv.clientWidth * dpr, h = cv.clientHeight * dpr;
  if (cv.width !== w || cv.height !== h) { cv.width = w; cv.height = h; }
  const [ww, wh] = scene.world;
  const s = Math.min(w / ww, h / wh) * 0.95;
  const ox = w / 2, oy = h / 2;
  const px = (x, y) => [ox + x * s, oy - y * s];
  cx.fillStyle = THEME.base; cx.fillRect(0, 0, w, h);
  if (obsImg && obsImg.complete)
    cx.drawImage(obsImg, ox - ww / 2 * s, oy - wh / 2 * s, ww * s, wh * s);
  const f = frames[frames.length - 1];
  // trails
  cx.globalAlpha = 0.5; cx.lineWidth = Math.max(1, 0.25 * s);
  const t0 = Math.max(0, frames.length - TRAIL);
  for (let i = 0; i < f.pos.length; i++) {
    if (!f.active[i]) continue;
    cx.strokeStyle = CYCLE[i % CYCLE.length];
    cx.beginPath();
    let started = false;
    for (let k = t0; k < frames.length; k++) {
      const g = frames[k];
      if (!g.active[i]) continue;
      const [x, y] = px(g.pos[i][0], g.pos[i][1]);
      if (!started) { cx.moveTo(x, y); started = true; } else cx.lineTo(x, y);
    }
    cx.stroke();
  }
  cx.globalAlpha = 1;
  for (let i = 0; i < f.pos.length; i++) {
    if (!f.active[i]) continue;
    const [x, y] = px(f.pos[i][0], f.pos[i][1]);
    cx.fillStyle = CYCLE[i % CYCLE.length];
    cx.beginPath();
    cx.arc(x, y, Math.max(2, (scene.radius[i] || 1) * s), 0, 7);
    cx.fill();
  }
  document.getElementById("m-t").textContent = f.t.toFixed(1) + " s";
  document.getElementById("m-active").textContent =
    f.active.reduce((a, b) => a + b, 0) + " / " + scene.robots;
  document.getElementById("m-done").textContent = f.done;
  document.getElementById("m-rr").textContent = f.rr;
  document.getElementById("m-re").textContent = f.re;
}
boot();
</script></body></html>
"""

"""Interactive playback viewer (counterpart of magics_tpu's viz/player.py):
export JSON -> one self-contained HTML file, the same document the JAX
package writes for the same export.

It stands in for the reference's interactive UI stack — the egui panels
(crates/magics/src/ui/, ~3300 LoC), the visualiser plugins
(crates/magics/src/planner/visualiser/mod.rs:33-49), the Catppuccin theme
(crates/magics/src/theme.rs), the pause/play + manual stepping controls
(crates/magics/src/pause_play.rs:16-47, planner/robot.rs:2448-2519) and the
keyboard bindings (crates/magics/src/input/). The simulation itself runs
headless on the GPU; interactivity happens offline over the exported run,
which keeps the device loop free of host round-trips.

Feature map (reference -> player):
  visualiser/waypoints.rs          -> waypoint markers + route polyline
  visualiser/tracers.rs            -> travelled-path tracers
  visualiser/communication_graph.rs-> robot-robot link lines (radius test)
  visualiser/communication_radius.rs-> comms-radius circles
  visualiser/robot.rs (meshes)     -> robot discs, per-robot Catppuccin color
                                      (theme.rs ColorAssociation)
  visualiser/factorgraphs.rs       -> predicted-trajectory polylines (when the
                                      export carries a `viz` belief log)
  visualiser/uncertainty.rs        -> variable uncertainty ellipses (ditto)
  planner/collisions.rs meshes     -> collision AABB flashes
  goal_area.rs                     -> goal-area rectangles
  ui/controls.rs + pause_play.rs   -> play/pause/step/speed/scrubber
  ui/settings.rs draw section      -> layer toggle checkboxes
  ui/data.rs (inspector)           -> click-a-robot inspector panel
  ui/metrics.rs + diagnostic/      -> live metric strip (active robots,
                                      cumulative collisions, messages)
  input/general.rs                 -> keyboard bindings (?, space, arrows, ...)

Usage:
    python -m magics_tpu_torch.viz.player export.json -o player.html
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# Catppuccin Macchiato (theme.rs uses the Catppuccin palette family).
_THEME = {
    "base": "#24273a",
    "mantle": "#1e2030",
    "crust": "#181926",
    "surface0": "#363a4f",
    "surface1": "#494d64",
    "text": "#cad3f5",
    "subtext": "#a5adcb",
    "overlay": "#6e738d",
    "red": "#ed8796",
    "green": "#a6da95",
    "yellow": "#eed49f",
    "blue": "#8aadf4",
    "mauve": "#c6a0f6",
    "teal": "#8bd5ca",
    "peach": "#f5a97f",
    "pink": "#f5bde6",
    "sky": "#91d7e3",
    "lavender": "#b7bdf8",
    "flamingo": "#f0c6c6",
    "maroon": "#ee99a0",
}

# per-robot color cycle = the accent colors (theme.rs ColorAssociation draws
# from the same palette)
_ROBOT_CYCLE = [
    "red", "green", "yellow", "blue", "mauve", "teal", "peach", "pink",
    "sky", "lavender", "flamingo", "maroon",
]


def build_player(export: dict, title: str | None = None) -> str:
    """Render the export dict into a single self-contained HTML document."""
    title = title or f"magics_tpu — {export.get('scenario', 'run')}"
    payload = json.dumps(export, separators=(",", ":"))
    theme = json.dumps(_THEME)
    cycle = json.dumps([_THEME[c] for c in _ROBOT_CYCLE])
    return (
        _HTML_TEMPLATE
        .replace("__TITLE__", title)
        .replace("__THEME__", theme)
        .replace("__CYCLE__", cycle)
        .replace("__DATA__", payload)
    )


_HTML_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
:root { color-scheme: dark; }
* { box-sizing: border-box; margin: 0; }
body { display: flex; height: 100vh; font: 13px/1.45 system-ui, sans-serif; }
#scene { flex: 1; display: block; cursor: grab; }
#panel { width: 300px; overflow-y: auto; padding: 12px; }
#panel h1 { font-size: 15px; margin-bottom: 2px; }
#panel h2 { font-size: 12px; text-transform: uppercase; letter-spacing: .06em;
            margin: 14px 0 6px; }
#panel label { display: flex; gap: 6px; align-items: center; padding: 1px 0; }
#bar { position: fixed; left: 0; right: 300px; bottom: 0; display: flex;
       gap: 8px; align-items: center; padding: 8px 12px; }
#bar button { border: none; border-radius: 4px; padding: 4px 10px;
              cursor: pointer; font-weight: 600; }
#scrub { flex: 1; }
#help { position: fixed; top: 12px; left: 12px; padding: 10px 14px;
        border-radius: 6px; display: none; white-space: pre; font-family: monospace; }
.kv { display: flex; justify-content: space-between; }
.kv span:last-child { font-variant-numeric: tabular-nums; }
canvas.spark { width: 100%; height: 46px; display: block; }
</style></head><body>
<canvas id="scene"></canvas>
<div id="panel">
  <h1 id="title"></h1>
  <div id="meta" style="font-size:11px"></div>
  <h2>Layers</h2><div id="layers"></div>
  <h2>Metrics</h2>
  <div class="kv"><span>active robots</span><span id="m-active"></span></div>
  <canvas class="spark" id="spark-active"></canvas>
  <div class="kv"><span>robot–robot collisions</span><span id="m-rr"></span></div>
  <div class="kv"><span>robot–environment</span><span id="m-re"></span></div>
  <canvas class="spark" id="spark-coll"></canvas>
  <div class="kv"><span>messages sent (int/ext)</span><span id="m-msg"></span></div>
  <h2>Inspector</h2>
  <div id="inspector" style="font-size:12px">click a robot…</div>
</div>
<div id="bar">
  <button id="play">▶</button>
  <input id="scrub" type="range" min="0" max="1000" value="0">
  <span id="clock" style="font-variant-numeric:tabular-nums"></span>
  <span id="speed"></span>
</div>
<div id="help"></div>
<script>
const THEME = __THEME__;
const CYCLE = __CYCLE__;
const DATA = __DATA__;

document.body.style.background = THEME.base;
document.body.style.color = THEME.text;
document.getElementById("panel").style.background = THEME.mantle;
document.getElementById("bar").style.background = THEME.mantle + "e6";
const helpBox = document.getElementById("help");
helpBox.style.background = THEME.crust;
helpBox.textContent = `space  play / pause
←/→    step one sample (shift: 10)
↑/↓    speed up / down
home   rewind
f      fit view
?      toggle this help`;

// ---------- data prep ----------
const robots = Object.entries(DATA.robots || {}).map(([id, r], i) => {
  const t0 = r.positions_start ?? (r.mission ? r.mission.started_at : 0);
  return { id, ...r, t0, color: CYCLE[i % CYCLE.length] };
});
const DT = DATA.sample_interval || 0.1;
const makespan = DATA.makespan ||
  Math.max(1, ...robots.map(r => r.t0 + r.positions.length * DT));
const N_FRAMES = Math.max(2, Math.round(makespan / DT) + 1);
const world = DATA.world_size || null;
const commsRadius = (((DATA.config || {}).robot || {}).communication || {}).radius || null;
const viz = DATA.viz || null;   // optional belief log {times, mean, cov}

function posAt(r, t) {           // linear interp inside the sample grid
  const k = (t - r.t0) / DT;
  if (k < 0 || r.positions.length === 0) return null;
  const k0 = Math.floor(k);
  if (k0 >= r.positions.length - 1) {
    const fin = r.mission && r.mission.finished_at > 0 ? r.mission.finished_at : Infinity;
    if (t > Math.max(fin, r.t0 + r.positions.length * DT) + DT) return null;
    return r.positions[r.positions.length - 1];
  }
  const a = r.positions[k0], b = r.positions[k0 + 1], f = k - k0;
  return [a[0] + (b[0] - a[0]) * f, a[1] + (b[1] - a[1]) * f];
}

// ---------- layers (ui/settings.rs "draw" section parity) ----------
const LAYERS = [
  ["robots", "robots", true],
  ["waypoints", "waypoints", true],
  ["routes", "route polylines", false],
  ["tracers", "tracers (travelled)", true],
  ["comms", "communication graph", true],
  ["radius", "communication radius", false],
  ["velocity", "velocity arrows", false],
  ["predicted", "predicted trajectories", !!viz],
  ["uncertainty", "uncertainty ellipses", false],
  ["tracking", "tracking projections", false],
  ["obstacles", "obstacles", true],
  ["collisions", "collision flashes", true],
  ["goals", "goal areas", true],
  ["labels", "robot ids", false],
];
const layerState = {};
const layersDiv = document.getElementById("layers");
for (const [key, name, def] of LAYERS) {
  if (key === "predicted" || key === "uncertainty" || key === "tracking") { if (!viz) continue; }
  layerState[key] = def;
  const l = document.createElement("label");
  const c = document.createElement("input");
  c.type = "checkbox"; c.checked = def;
  c.onchange = () => { layerState[key] = c.checked; draw(); };
  l.append(c, name);
  layersDiv.append(l);
}

// ---------- camera ----------
const canvas = document.getElementById("scene");
const ctx = canvas.getContext("2d");
let cam = { x: 0, y: 0, scale: 6 };
function fitView() {
  const w = canvas.width, h = canvas.height;
  let bounds;
  if (world) bounds = [-world[0] / 2, -world[1] / 2, world[0] / 2, world[1] / 2];
  else {
    bounds = [Infinity, Infinity, -Infinity, -Infinity];
    for (const r of robots) for (const p of r.positions) {
      bounds[0] = Math.min(bounds[0], p[0]); bounds[1] = Math.min(bounds[1], p[1]);
      bounds[2] = Math.max(bounds[2], p[0]); bounds[3] = Math.max(bounds[3], p[1]);
    }
  }
  const bw = bounds[2] - bounds[0] || 1, bh = bounds[3] - bounds[1] || 1;
  cam.scale = Math.min(w / bw, h / bh) * 0.92;
  cam.x = (bounds[0] + bounds[2]) / 2; cam.y = (bounds[1] + bounds[3]) / 2;
}
function toPx(x, y) {
  return [canvas.width / 2 + (x - cam.x) * cam.scale,
          canvas.height / 2 - (y - cam.y) * cam.scale];
}
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  cam.scale *= Math.pow(1.0015, -e.deltaY);
  draw();
}, { passive: false });
let drag = null;
canvas.addEventListener("mousedown", e => { drag = [e.clientX, e.clientY]; });
window.addEventListener("mousemove", e => {
  if (!drag) return;
  cam.x -= (e.clientX - drag[0]) / cam.scale;
  cam.y += (e.clientY - drag[1]) / cam.scale;
  drag = [e.clientX, e.clientY];
  draw();
});
window.addEventListener("mouseup", e => {
  if (drag && Math.abs(e.clientX - drag[0]) < 3 && Math.abs(e.clientY - drag[1]) < 3)
    pick(e.clientX, e.clientY);
  drag = null;
});

// ---------- inspector (ui/data.rs parity) ----------
let selected = null;
function pick(px, py) {
  const t = frame * DT;
  let best = null, bestD = 12 * 12;
  for (const r of robots) {
    const p = posAt(r, t);
    if (!p) continue;
    const [x, y] = toPx(p[0], p[1]);
    const d = (x - px) ** 2 + (y - py) ** 2;
    if (d < bestD) { best = r; bestD = d; }
  }
  selected = best;
  const el = document.getElementById("inspector");
  if (!best) { el.textContent = "click a robot…"; draw(); return; }
  const m = best.messages || {};
  el.innerHTML =
    `<div class="kv"><span>robot</span><span style="color:${best.color}">#${best.id}</span></div>` +
    `<div class="kv"><span>radius</span><span>${best.radius.toFixed(2)} m</span></div>` +
    `<div class="kv"><span>planning</span><span>${best.planning_strategy || "?"}</span></div>` +
    `<div class="kv"><span>started</span><span>${best.mission.started_at.toFixed(1)} s</span></div>` +
    `<div class="kv"><span>finished</span><span>${best.mission.finished_at ? best.mission.finished_at.toFixed(1) + " s" : "—"}</span></div>` +
    `<div class="kv"><span>collisions r/e</span><span>${best.collisions.robots}/${best.collisions.environment}</span></div>` +
    (m.sent ? `<div class="kv"><span>msgs sent i/e</span><span>${m.sent.internal}/${m.sent.external}</span></div>` +
              `<div class="kv"><span>msgs recv i/e</span><span>${m.received.internal}/${m.received.external}</span></div>` : "");
  draw();
}

// ---------- drawing ----------
function ellipsePath(cx, cy, sxx, sxy, syy, k) {
  // eigen-decompose the 2x2 covariance (uncertainty.rs draws the same ellipse)
  const tr = sxx + syy, det = sxx * syy - sxy * sxy;
  const d = Math.sqrt(Math.max(tr * tr / 4 - det, 0));
  const l1 = Math.max(tr / 2 + d, 1e-12), l2 = Math.max(tr / 2 - d, 1e-12);
  const ang = Math.abs(sxy) < 1e-12 ? (sxx >= syy ? 0 : Math.PI / 2)
            : Math.atan2(l1 - sxx, sxy);
  const [px, py] = toPx(cx, cy);
  ctx.ellipse(px, py, Math.sqrt(l1) * k * cam.scale,
              Math.sqrt(l2) * k * cam.scale, -ang, 0, 2 * Math.PI);
}

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) { canvas.width = w; canvas.height = h; }
  const t = frame * DT;
  ctx.fillStyle = THEME.base; ctx.fillRect(0, 0, w, h);

  if (layerState.obstacles && DATA.obstacles) {
    ctx.fillStyle = THEME.surface1;
    for (const ob of Object.values(DATA.obstacles)) {
      ctx.beginPath();
      if (ob.type === "Circle") {
        const [x, y] = toPx(ob.center[0], ob.center[1]);
        ctx.arc(x, y, ob.radius * cam.scale, 0, 2 * Math.PI);
      } else {
        ob.vertices.forEach((v, i) => {
          const [x, y] = toPx(v[0], v[1]);
          i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
        });
        ctx.closePath();
      }
      ctx.fill();
    }
  }

  if (layerState.goals && DATA.goal_areas) {
    for (const g of Object.values(DATA.goal_areas)) {
      const [x0, y0] = toPx(g.aabb.mins[0], g.aabb.maxs[1]);
      const [x1, y1] = toPx(g.aabb.maxs[0], g.aabb.mins[1]);
      ctx.strokeStyle = THEME.green; ctx.setLineDash([6, 4]);
      ctx.strokeRect(x0, y0, x1 - x0, y1 - y0);
      ctx.setLineDash([]);
    }
  }

  const live = robots.map(r => [r, posAt(r, t)]).filter(([, p]) => p);

  if (layerState.comms && commsRadius) {
    ctx.strokeStyle = THEME.overlay; ctx.lineWidth = 1; ctx.globalAlpha = 0.7;
    for (let i = 0; i < live.length; i++) for (let j = i + 1; j < live.length; j++) {
      const [ , a] = live[i], [ , b] = live[j];
      const d2 = (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2;
      if (d2 <= commsRadius * commsRadius) {
        const [x0, y0] = toPx(a[0], a[1]), [x1, y1] = toPx(b[0], b[1]);
        ctx.beginPath(); ctx.moveTo(x0, y0); ctx.lineTo(x1, y1); ctx.stroke();
      }
    }
    ctx.globalAlpha = 1;
  }

  if (layerState.radius && commsRadius) {
    ctx.strokeStyle = THEME.surface1;
    for (const [, p] of live) {
      ctx.beginPath();
      const [x, y] = toPx(p[0], p[1]);
      ctx.arc(x, y, commsRadius * cam.scale, 0, 2 * Math.PI); ctx.stroke();
    }
  }

  if (layerState.routes) {
    ctx.lineWidth = 1; ctx.globalAlpha = 0.5;
    for (const r of robots) {
      ctx.strokeStyle = r.color;
      ctx.beginPath();
      r.mission.waypoints.forEach((wp, i) => {
        const [x, y] = toPx(wp[0], wp[1]);
        i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
      });
      ctx.stroke();
    }
    ctx.globalAlpha = 1;
  }

  if (layerState.waypoints) {
    for (const r of robots) {
      ctx.strokeStyle = r.color; ctx.globalAlpha = 0.8;
      for (const wp of r.mission.waypoints) {
        const [x, y] = toPx(wp[0], wp[1]);
        ctx.strokeRect(x - 3, y - 3, 6, 6);
      }
    }
    ctx.globalAlpha = 1;
  }

  if (layerState.tracers) {
    ctx.lineWidth = 1.5;
    for (const r of robots) {
      const kEnd = Math.min(Math.floor((t - r.t0) / DT), r.positions.length - 1);
      if (kEnd < 1) continue;
      ctx.strokeStyle = r.color; ctx.globalAlpha = 0.6;
      ctx.beginPath();
      for (let k = Math.max(0, kEnd - 60); k <= kEnd; k++) {
        const [x, y] = toPx(r.positions[k][0], r.positions[k][1]);
        k === Math.max(0, kEnd - 60) ? ctx.moveTo(x, y) : ctx.lineTo(x, y);
      }
      ctx.stroke();
    }
    ctx.globalAlpha = 1;
  }

  // predicted trajectories + uncertainty (factorgraphs.rs / uncertainty.rs)
  if (viz && (layerState.predicted || layerState.uncertainty || layerState.tracking)) {
    const vdt = viz.dt || DT;
    const kf = Math.min(Math.max(Math.round((t - viz.t0) / vdt), 0), viz.mean.length - 1);
    const means = viz.mean[kf];            // [R][V] of [x,y] | null
    const covs = viz.cov ? viz.cov[kf] : null;  // [R][V] of [xx,xy,yy] | null
    robots.forEach((r, ri) => {
      if (!posAt(r, t) || !means[ri]) return;
      const pts = means[ri].filter(m => m);
      if (!pts.length) return;
      if (layerState.predicted) {
        ctx.strokeStyle = r.color; ctx.lineWidth = 1; ctx.globalAlpha = 0.9;
        ctx.beginPath();
        pts.forEach((m, i) => {
          const [x, y] = toPx(m[0], m[1]);
          i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
        });
        ctx.stroke();
        for (const m of pts) {
          const [x, y] = toPx(m[0], m[1]);
          ctx.fillStyle = r.color;
          ctx.fillRect(x - 1.5, y - 1.5, 3, 3);
        }
        ctx.globalAlpha = 1;
      }
      if (layerState.uncertainty && covs && covs[ri]) {
        ctx.strokeStyle = r.color; ctx.globalAlpha = 0.45;
        covs[ri].forEach((c, i) => {
          const m = means[ri][i];
          if (!c || !m) return;
          ctx.beginPath();
          ellipsePath(m[0], m[1], c[0], c[1], c[2], 1.0);
          ctx.stroke();
        });
        ctx.globalAlpha = 1;
      }
      // tracking-factor measurement points (visualiser/tracking.rs):
      // a cross at the projection, a faint line from the variable to it
      const trks = viz.tracking ? viz.tracking[kf] : null;
      if (layerState.tracking && trks && trks[ri]) {
        ctx.strokeStyle = r.color; ctx.globalAlpha = 0.7;
        trks[ri].forEach((p, i) => {
          const m = means[ri][i + 1];  // tracking factors sit on vars 1..V-2
          if (!p) return;
          const [x, y] = toPx(p[0], p[1]);
          ctx.beginPath();
          ctx.moveTo(x - 3, y - 3); ctx.lineTo(x + 3, y + 3);
          ctx.moveTo(x - 3, y + 3); ctx.lineTo(x + 3, y - 3);
          ctx.stroke();
          if (m) {
            const [mx, my] = toPx(m[0], m[1]);
            ctx.globalAlpha = 0.3;
            ctx.beginPath(); ctx.moveTo(mx, my); ctx.lineTo(x, y); ctx.stroke();
            ctx.globalAlpha = 0.7;
          }
        });
        ctx.globalAlpha = 1;
      }
    });
  }

  if (layerState.collisions && DATA.collisions) {
    ctx.strokeStyle = THEME.red; ctx.lineWidth = 2;
    const flash = ev => {
      if (ev.time === undefined || Math.abs(ev.time - t) > 1.0) return;
      for (const bb of ev.aabbs) {
        const [x0, y0] = toPx(bb.mins[0], bb.maxs[1]);
        const [x1, y1] = toPx(bb.maxs[0], bb.mins[1]);
        ctx.strokeRect(x0, y0, Math.max(x1 - x0, 4), Math.max(y1 - y0, 4));
      }
    };
    (DATA.collisions.robots || []).forEach(flash);
    (DATA.collisions.environment || []).forEach(flash);
  }

  if (layerState.robots) {
    for (const [r, p] of live) {
      const [x, y] = toPx(p[0], p[1]);
      ctx.fillStyle = r.color;
      ctx.beginPath();
      ctx.arc(x, y, Math.max(r.radius * cam.scale, 2), 0, 2 * Math.PI);
      ctx.fill();
      if (r === selected) {
        ctx.strokeStyle = THEME.text; ctx.lineWidth = 2;
        ctx.beginPath();
        ctx.arc(x, y, Math.max(r.radius * cam.scale, 2) + 3, 0, 2 * Math.PI);
        ctx.stroke();
      }
      if (layerState.labels) {
        ctx.fillStyle = THEME.text;
        ctx.fillText(r.id, x + 5, y - 5);
      }
      if (layerState.velocity) {
        const vs = r.velocities || [];
        const kv = Math.min(Math.floor((t - r.t0) / DT), vs.length - 1);
        if (kv >= 0 && vs[kv]) {
          const v = vs[kv].velocity;  // bevy Vec3: ground plane [0], [2]
          const [x1, y1] = toPx(p[0] + v[0] * 0.5, p[1] + v[2] * 0.5);
          ctx.strokeStyle = r.color; ctx.lineWidth = 1.5;
          ctx.beginPath(); ctx.moveTo(x, y); ctx.lineTo(x1, y1); ctx.stroke();
        }
      }
    }
  }

  // metric strip
  document.getElementById("m-active").textContent = String(live.length);
  let rr = 0, re = 0;
  for (const ev of (DATA.collisions?.robots || [])) if ((ev.time ?? 0) <= t) rr++;
  for (const ev of (DATA.collisions?.environment || [])) if ((ev.time ?? 0) <= t) re++;
  document.getElementById("m-rr").textContent = String(rr);
  document.getElementById("m-re").textContent = String(re);
  let mi = 0, me = 0;
  for (const r of robots) if (r.messages?.sent) { mi += r.messages.sent.internal; me += r.messages.sent.external; }
  document.getElementById("m-msg").textContent = `${mi}/${me}`;
  document.getElementById("clock").textContent =
    `${t.toFixed(1)} / ${makespan.toFixed(1)} s`;
  document.getElementById("scrub").value = Math.round(1000 * frame / (N_FRAMES - 1));
  drawSparks(t);
}

// ---------- metric sparklines (ui/metrics.rs parity) ----------
const activeSeries = [];
for (let k = 0; k < N_FRAMES; k += Math.max(1, Math.floor(N_FRAMES / 240))) {
  const t = k * DT;
  activeSeries.push([t, robots.filter(r => posAt(r, t)).length]);
}
function spark(id, series, t, color) {
  const cv = document.getElementById(id);
  const w = cv.clientWidth || 276, h = 46;
  cv.width = w; cv.height = h;
  const g = cv.getContext("2d");
  g.fillStyle = THEME.crust; g.fillRect(0, 0, w, h);
  const maxV = Math.max(1, ...series.map(s => s[1]));
  g.strokeStyle = color; g.beginPath();
  series.forEach((s, i) => {
    const x = s[0] / makespan * w, y = h - 3 - (s[1] / maxV) * (h - 8);
    i ? g.lineTo(x, y) : g.moveTo(x, y);
  });
  g.stroke();
  g.strokeStyle = THEME.overlay;
  g.beginPath(); g.moveTo(t / makespan * w, 0); g.lineTo(t / makespan * w, h); g.stroke();
}
let collSeries = null;
function drawSparks(t) {
  spark("spark-active", activeSeries, t, THEME.blue);
  if (!collSeries) {
    const evs = [...(DATA.collisions?.robots || []), ...(DATA.collisions?.environment || [])]
      .map(e => e.time ?? 0).sort((a, b) => a - b);
    collSeries = activeSeries.map(([tt]) => [tt, evs.filter(e => e <= tt).length]);
  }
  spark("spark-coll", collSeries, t, THEME.red);
}

// ---------- playback (pause_play.rs + manual stepping parity) ----------
let frame = 0, playing = false, speed = 1, lastWall = null;
const playBtn = document.getElementById("play");
playBtn.style.background = THEME.blue; playBtn.style.color = THEME.crust;
function setPlaying(p) { playing = p; playBtn.textContent = p ? "⏸" : "▶"; lastWall = null; }
playBtn.onclick = () => setPlaying(!playing);
document.getElementById("scrub").oninput = e => {
  frame = Math.round(e.target.value / 1000 * (N_FRAMES - 1)); draw();
};
function speedLabel() {
  document.getElementById("speed").textContent = `×${speed}`;
}
window.addEventListener("keydown", e => {
  if (e.key === " ") { setPlaying(!playing); e.preventDefault(); }
  else if (e.key === "ArrowRight") { frame = Math.min(frame + (e.shiftKey ? 10 : 1), N_FRAMES - 1); draw(); }
  else if (e.key === "ArrowLeft") { frame = Math.max(frame - (e.shiftKey ? 10 : 1), 0); draw(); }
  else if (e.key === "ArrowUp") { speed = Math.min(speed * 2, 16); speedLabel(); }
  else if (e.key === "ArrowDown") { speed = Math.max(speed / 2, 0.25); speedLabel(); }
  else if (e.key === "Home") { frame = 0; draw(); }
  else if (e.key === "f") { fitView(); draw(); }
  else if (e.key === "?") {
    helpBox.style.display = helpBox.style.display === "block" ? "none" : "block";
  }
});
function tick(wall) {
  if (playing) {
    if (lastWall !== null) {
      frame += (wall - lastWall) / 1000 * speed / DT;
      if (frame >= N_FRAMES - 1) { frame = N_FRAMES - 1; setPlaying(false); }
    }
    lastWall = wall;
    draw();
  }
  requestAnimationFrame(tick);
}

document.getElementById("title").textContent = DATA.scenario || "run";
document.getElementById("meta").textContent =
  `${robots.length} robots · makespan ${makespan.toFixed(1)} s · seed ${DATA.prng_seed ?? "?"}`;
document.getElementById("meta").style.color = THEME.subtext;
speedLabel();
window.addEventListener("resize", () => { draw(); });
// size the canvas bitmap before fitting the camera (a fresh canvas is 300x150)
canvas.width = canvas.clientWidth; canvas.height = canvas.clientHeight;
fitView(); draw();
requestAnimationFrame(tick);
</script></body></html>
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m magics_tpu_torch.viz.player", description=__doc__
    )
    p.add_argument("export", help="export JSON produced by the simulator")
    p.add_argument("-o", "--out", help="output HTML path (default: <export>.html)")
    args = p.parse_args(argv)

    data = json.loads(Path(args.export).read_text())
    out = Path(args.out) if args.out else Path(args.export).with_suffix(".html")
    out.write_text(build_player(data))
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Interactive trajectory visualization — the live-view capability the
reference gets from RViz (gtsam_fusion/config/rviz_config.rviz: fused/LOAM/
ROVIO paths + TF frames), re-imagined for this offline-replay architecture
as a single self-contained HTML file: no server, no dependencies, open in
any browser.

The view: top-down (x, y) trajectories per estimator with pan/zoom, hover
readout (t, position, per-estimator error), degeneracy-gate drop markers,
and an error-over-time strip synced to the cursor — i.e. the information
content of the reference's RViz session plus the DiagnosticMessage stream
in one artifact that can be committed next to a run report.

The port's own copy of ``vil_sensor_fusion_tpu/eval/trajectory_view.py``
(which imports no JAX), so the port depends on nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 0; background: #111;
        color: #ddd; }}
 #hud {{ padding: 6px 10px; font-size: 13px; white-space: pre; }}
 canvas {{ display: block; background: #181818; }}
 .legend span {{ margin-right: 14px; }}
</style></head><body>
<div id="hud" class="legend"></div>
<canvas id="map"></canvas><canvas id="err"></canvas>
<script>
const DATA = {data};
const mapC = document.getElementById('map');
const errC = document.getElementById('err');
const hud = document.getElementById('hud');
const W = window.innerWidth, H = Math.floor(window.innerHeight * 0.72);
mapC.width = W; mapC.height = H;
errC.width = W; errC.height = Math.floor(window.innerHeight * 0.2);
let view = null;
function fitView() {{
  let xs = [], ys = [];
  for (const tr of DATA.tracks) for (const p of tr.xy) {{
    xs.push(p[0]); ys.push(p[1]); }}
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const s = 0.9 * Math.min(W / Math.max(x1 - x0, 1e-6),
                           H / Math.max(y1 - y0, 1e-6));
  view = {{ s: s, cx: (x0 + x1) / 2, cy: (y0 + y1) / 2 }};
}}
fitView();
const toPx = (x, y) => [W / 2 + (x - view.cx) * view.s,
                        H / 2 - (y - view.cy) * view.s];
let cursorT = null;
function draw() {{
  const g = mapC.getContext('2d');
  g.clearRect(0, 0, W, H);
  for (const tr of DATA.tracks) {{
    g.strokeStyle = tr.color; g.lineWidth = tr.name === 'fused' ? 2 : 1.2;
    g.beginPath();
    tr.xy.forEach((p, i) => {{
      const [px, py] = toPx(p[0], p[1]);
      i ? g.lineTo(px, py) : g.moveTo(px, py);
    }});
    g.stroke();
    if (tr.drops) {{
      g.fillStyle = '#ff5252';
      for (const i of tr.drops) {{
        const [px, py] = toPx(tr.xy[i][0], tr.xy[i][1]);
        g.beginPath(); g.arc(px, py, 4, 0, 6.3); g.fill();
      }}
    }}
    if (cursorT !== null) {{
      let k = 0;
      while (k + 1 < tr.t.length && tr.t[k + 1] <= cursorT) k++;
      const [px, py] = toPx(tr.xy[k][0], tr.xy[k][1]);
      g.fillStyle = tr.color;
      g.beginPath(); g.arc(px, py, 5, 0, 6.3); g.fill();
    }}
  }}
  const e = errC.getContext('2d');
  e.clearRect(0, 0, W, errC.height);
  const tMax = DATA.t_max, eMax = DATA.err_max || 1;
  for (const tr of DATA.tracks) {{
    if (!tr.err) continue;
    e.strokeStyle = tr.color; e.lineWidth = 1; e.beginPath();
    tr.t.forEach((t, i) => {{
      const px = t / tMax * W;
      const py = errC.height - tr.err[i] / eMax * (errC.height - 8) - 4;
      i ? e.lineTo(px, py) : e.moveTo(px, py);
    }});
    e.stroke();
  }}
  if (cursorT !== null) {{
    e.strokeStyle = '#888'; e.beginPath();
    const px = cursorT / tMax * W;
    e.moveTo(px, 0); e.lineTo(px, errC.height); e.stroke();
  }}
  let txt = DATA.tracks.map(tr =>
    `<span style="color:${{tr.color}}">&#9632; ${{tr.name}}</span>`).join('');
  txt += `<span style="color:#ff5252">&#9679; gate drop</span>`;
  if (cursorT !== null) txt += `  t = ${{cursorT.toFixed(2)}} s`;
  hud.innerHTML = txt;
}}
mapC.addEventListener('wheel', ev => {{
  ev.preventDefault();
  view.s *= ev.deltaY < 0 ? 1.15 : 1 / 1.15;
  draw();
}});
let drag = null;
mapC.addEventListener('mousedown', ev => drag = [ev.clientX, ev.clientY]);
window.addEventListener('mouseup', () => drag = null);
mapC.addEventListener('mousemove', ev => {{
  if (drag) {{
    view.cx -= (ev.clientX - drag[0]) / view.s;
    view.cy += (ev.clientY - drag[1]) / view.s;
    drag = [ev.clientX, ev.clientY];
    draw();
  }}
}});
errC.addEventListener('mousemove', ev => {{
  cursorT = ev.clientX / W * DATA.t_max; draw();
}});
draw();
</script></body></html>
"""

_COLORS = {"fused": "#4fc3f7", "vio": "#ffb74d", "lidar": "#aed581",
           "gt": "#e0e0e0"}


def write_view(
    path: str,
    tracks: dict,
    gate_keep: np.ndarray | None = None,
    title: str = "vil_sensor_fusion_tpu trajectory",
) -> str:
    """Write the interactive HTML view.

    ``tracks``: name → (times (N,), poses (N,7)) — typically fused / vio /
    lidar / gt. Errors are computed against the 'gt' track when present
    (nearest-in-time). ``gate_keep``: per-lidar-event 0/1; drops become
    red markers on the lidar track.
    """
    gt = tracks.get("gt")
    data_tracks = []
    err_max = 0.0
    t_max = 1e-9
    for name, (t, poses) in tracks.items():
        t = np.asarray(t, np.float64)
        poses = np.asarray(poses, np.float64)
        xy = poses[:, 4:6]
        entry = {
            "name": name,
            "color": _COLORS.get(name, "#ba68c8"),
            "t": np.round(t, 4).tolist(),
            "xy": np.round(xy, 3).tolist(),
        }
        if gt is not None and name != "gt":
            gt_t = np.asarray(gt[0], np.float64)
            gt_p = np.asarray(gt[1], np.float64)
            idx = np.clip(np.searchsorted(gt_t, t), 0, len(gt_t) - 1)
            err = np.linalg.norm(poses[:, 4:7] - gt_p[idx, 4:7], axis=-1)
            entry["err"] = np.round(err, 3).tolist()
            err_max = max(err_max, float(err.max(initial=0.0)))
        if name == "lidar" and gate_keep is not None:
            keep = np.asarray(gate_keep)
            entry["drops"] = np.nonzero(keep < 0.5)[0].tolist()
        t_max = max(t_max, float(t.max(initial=0.0)))
        data_tracks.append(entry)

    payload = {"tracks": data_tracks, "t_max": t_max, "err_max": err_max}
    html = _PAGE.format(title=title, data=json.dumps(payload))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path

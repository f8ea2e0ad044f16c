"""A checkout with two tiny cells beside the benchmark's own, added as
files and entries alone: ``tiny-town.lanes2`` (2 lanes, 160×120, 0.2 s,
narrow maps) and ``tiny-road.stream`` (160×120, 8 slots, a 0.6 s drive).
They run on the CPU in seconds, through the same drivers, readers and
check."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
LANES, STREAM = "tiny-town.lanes2", "tiny-road.stream"


def _edit(path: Path, **changes) -> dict:
    d = json.loads(path.read_text())
    d.update(changes)
    return d


def make_root(tmp: Path) -> Path:
    """Copy ``BENCHMARK.json`` and ``vilbench/`` to ``tmp`` and add the
    tiny cells there."""
    shutil.copytree(REPO / "vilbench", tmp / "vilbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp / "vilbench"
    town = _edit(base / "configs/town-bench.json", name="tiny-town",
                 duration_s=0.2,
                 rig=dict(cam_w=160, cam_h=120, corner_capacity=4096,
                          surf_capacity=8192, submap_corners=512,
                          submap_surfs=1024))
    road = _edit(base / "configs/road-soak.json", name="tiny-road",
                 cam_w=160, cam_h=120, landmarks=8, duration_s=0.6)
    lanes = _edit(base / "workloads/town-bench.lanes8.json",
                  config="tiny-town", params={"lanes": 2})
    stream = _edit(base / "workloads/road-soak.stream.json",
                   config="tiny-road",
                   params={"warm_chunks": 2, "own_chunks": 1,
                           "compare_pairs": 1, "trace_chunks": 1})
    for rel, d in (("configs/tiny-town.json", town),
                   ("configs/tiny-road.json", road),
                   (f"workloads/{LANES}.json", lanes),
                   (f"workloads/{STREAM}.json", stream)):
        (base / rel).write_text(json.dumps(d, indent=1))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    c_town, c_road = bench["configs"]
    w_town, w_road = bench["workloads"]
    bench["configs"] += [
        dict(c_town, name="tiny-town", file="vilbench/configs/tiny-town.json"),
        dict(c_road, name="tiny-road", file="vilbench/configs/tiny-road.json")]
    bench["workloads"] += [dict(w_town, name=LANES, config="tiny-town"),
                           dict(w_road, name=STREAM, config="tiny-road")]
    twins = {w_town["name"]: [LANES], w_road["name"]: [STREAM]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for w in m["workloads"] for t in twins[w]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp

"""Set-up shared by the benchmark's tests.

``vilbench_tiny.make_root`` unpacks ``BENCHMARK.json``'s configurations and
cells as exactly ``town-bench`` and ``road-soak``, so it raises once the
benchmark has a third configuration. The tests here get this version
instead: it hands the helper a view of the repository whose
``BENCHMARK.json`` holds those two cells alone, lets it add its tiny twins,
then puts every other entry of the real file back, unchanged. The dry runs
of ``test_vilbench_imports`` call the helper in a subprocess, which this
does not reach.
"""

from __future__ import annotations

import json
from pathlib import Path

from vilbench.tests import vilbench_tiny as tiny

# The cells the helper makes tiny twins of, with their configurations.
KNOWN = {"town-bench.lanes8": "town-bench", "road-soak.stream": "road-soak"}
_helper = tiny.make_root


def two_cells(bench: dict) -> dict:
    """``bench`` cut to the known cells: their configurations, and each
    metric with its ``workloads`` cut to them (left out where none stay)."""
    view = dict(bench,
                configs=[c for c in bench["configs"]
                         if c["name"] in KNOWN.values()],
                workloads=[w for w in bench["workloads"]
                           if w["name"] in KNOWN])
    for key in ("end_to_end", "per_layer"):
        view[key] = []
        for m in bench[key]:
            if "workloads" in m:
                m = dict(m, workloads=[w for w in m["workloads"]
                                       if w in KNOWN])
                if not m["workloads"]:
                    continue
            view[key].append(m)
    return view


def make_root(tmp: Path) -> Path:
    """What ``vilbench_tiny.make_root`` makes, for a benchmark of any
    number of cells."""
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    view = tmp.parent / f"{tmp.name}.view"
    view.mkdir()
    (view / "vilbench").symlink_to(tiny.REPO / "vilbench")
    (view / "BENCHMARK.json").write_text(json.dumps(two_cells(real)))
    repo, tiny.REPO = tiny.REPO, view
    try:
        root = _helper(tmp)
    finally:
        tiny.REPO = repo
    made = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):
        have = {x["name"] for x in real[key]}
        real[key] += [x for x in made[key] if x["name"] not in have]
    for key in ("end_to_end", "per_layer"):
        twins = {m["name"]: [w for w in m.get("workloads", [])
                             if w not in KNOWN] for m in made[key]}
        for m in real[key]:
            if "workloads" in m:
                m["workloads"] += twins.get(m["name"], [])
    (root / "BENCHMARK.json").write_text(json.dumps(real, indent=1))
    return root


tiny.make_root = make_root

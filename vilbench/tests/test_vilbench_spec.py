"""Every file of the benchmark is found by name and parses, BENCHMARK.json
keeps the contract's shape, and a cell added as files and entries alone is
picked up."""

from __future__ import annotations

import json
import re

import pytest

from vilbench import harness
from vilbench.tests.vilbench_tiny import LANES, REPO, STREAM, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vilbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vilbench/")
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for text in (x.get(k, "") for k in ("why", "layer", "source")
                 for s in ("configs", "workloads", "per_layer")
                 for x in BENCH[s]):
        assert len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    spec = harness.cell_spec(REPO, cell)
    work = spec["workload"]
    assert set(work) == {"config", "traffic", "driver", "params", "limits"}
    assert work["traffic"] == spec["entry"]["traffic"]
    harness.load_module(spec["base"], "drivers", work["driver"])
    assert spec["config"]["name"] == work["config"]
    assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"]
    for name in spec["per_layer"]:
        assert callable(harness.load_module(spec["base"], "metrics",
                                            name).read)


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_data_file_parses_and_is_named(kind):
    files = sorted((REPO / "vilbench" / kind).glob("*.json"))
    assert files
    listed = {"configs": {c["file"] for c in BENCH["configs"]},
              "workloads": {f"vilbench/workloads/{w['name']}.json"
                            for w in BENCH["workloads"]}}[kind]
    for f in files:
        json.loads(f.read_text())
        assert str(f.relative_to(REPO)) in listed


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    root = make_root(tmp_path)
    for cell, twin, driver in ((LANES, "town-bench.lanes8", "lanes_replay"),
                               (STREAM, "road-soak.stream", "stream_chunks")):
        spec = harness.cell_spec(root, cell)
        assert spec["workload"]["driver"] == driver
        assert spec["base"] == root / "vilbench"
        assert spec["config"]["name"] == spec["entry"]["config"]
        assert (set(spec["per_layer"])
                == set(harness.cell_spec(REPO, twin)["per_layer"]))
        assert (set(spec["end_to_end"])
                == set(harness.cell_spec(REPO, twin)["end_to_end"]))

"""The last line of a run: its keys, the numbers compared last, a CPU run of
the tiny cells through both traces, and the refusal without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from vilbench import harness
from vilbench.tests.vilbench_tiny import LANES, REPO, STREAM, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell, trace", [
    (LANES, False), (LANES, True), (STREAM, False), (STREAM, True)])
def test_a_cpu_run_prints_the_contracts_line(root, cell, trace):
    torch.set_num_threads(2)
    res, lines = harness.run(cell, 2**31 + 12345, 0.01, trace, "cpu",
                             root=root)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    spec = harness.cell_spec(root, cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # No device on the CPU: only the host and span metrics read.
        assert set(line["metrics"]) <= set(spec["per_layer"])
        assert "aten_ops_per_event" in line["metrics"]
        if cell == LANES:
            assert {"fusion_ms_per_step", "lidar_ms_per_sweep",
                    "vio_ms_per_frame", "tracker_ms_per_frame"} <= set(
                        line["metrics"])
    else:
        assert set(line["metrics"]) == set(spec["end_to_end"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(x.startswith(f"check {name}: ") for x in lines)
    assert not harness.forbidden_modules()


def test_the_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "vilbench.run", "--workload",
                        "town-bench.lanes8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_the_run_fails_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and vilbench/ has no program to
    run: the run raises before it prints anything."""
    make_root(tmp_path)
    p = subprocess.run([sys.executable, "-c",
                        "from vilbench import harness\n"
                        f"harness.run({LANES!r}, 1, 0.01, False, 'cpu')"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode != 0 and p.stdout == ""
    assert "No module named 'vil_sensor_fusion_tpu_torch'" in p.stderr

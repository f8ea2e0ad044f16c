"""The control of ``correct`` on the card: the reference computed in TF32
(the nearest precision below the configurations' full float32) in the
program's place fails the check, in each of the benchmark's cells at its
own size, with a short window (about a minute a seed). ``python3 -m
vilbench.calibrate --side control`` prints the readings; PERF.md gives
them with the limits."""

from __future__ import annotations

import json

import pytest

from vilbench import harness
from vilbench.tests.vilbench_tiny import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 5003, 3987654321])
def test_the_tf32_control_is_not_correct(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is TF32 on the card")
    # A few stream chunks, so that pairs of window chunks are compared.
    seconds = 8.0 if cell.endswith(".stream") else 0.01
    res, lines = harness.run(cell, seed, seconds, False, "cuda:0",
                             side="control")
    assert res["correct"] is False, lines

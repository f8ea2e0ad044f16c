"""``diagnostics_ms_per_run``: the ground-truth errors of an experiment (the
``experiments.diagnostics`` span of ``eval/experiments.run_scenario``:
ground truth at the fused events, the VIO, LiDAR and fused errors over
time and their ATEs) in the profiler slice, in ms per run (``vil.runs``).
The reader prints the slice's counters to standard error: the sweeps with
a frozen ICP direction (``icp.frozen_sweeps``) and those the gate dropped
(``gate.dropped_sweeps``), beside the sweeps (``odometry.sweeps``)."""

from __future__ import annotations

import sys

from ._spans import ms_per, observe, recorded  # noqa: F401  (the hook)

NAME = "diagnostics_ms_per_run"
SPANS = ("experiments.diagnostics",)
COUNTER = "vil.runs"
SHOWN = ("odometry.sweeps", "icp.frozen_sweeps", "gate.dropped_sweeps")


def read(ctx):
    tr = recorded(ctx, NAME)
    if tr is not None:
        print("counters in the slice: " + ", ".join(
            f"{k} {tr.counts.get(k)}" for k in SHOWN),
            file=sys.stderr, flush=True)
    return ms_per(ctx, NAME, SPANS, COUNTER)

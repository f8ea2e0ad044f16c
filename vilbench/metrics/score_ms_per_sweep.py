"""``score_ms_per_sweep``: the degeneracy scoring of an experiment (the
``experiments.score`` span of ``eval/experiments.run_scenario``: the
metric scores of the Hessian series, the raw gate and the dist slopes) in
the profiler slice, in ms per sweep (``odometry.sweeps``). The reader
prints the slice's counters to standard error: the sweeps with a frozen
ICP direction (``icp.frozen_sweeps``) and dropped by the gate
(``gate.dropped_sweeps``), and the engine's replays of captured graphs
per step."""

from __future__ import annotations

import sys

from ._spans import ms_per, observe, recorded  # noqa: F401  (the hook)

NAME = "score_ms_per_sweep"
SPANS = ("experiments.score",)
COUNTER = "odometry.sweeps"
SHOWN = ("odometry.sweeps", "icp.frozen_sweeps", "gate.dropped_sweeps",
         "engine.steps", "engine.graph_replays", "engine.graph_captures")


def read(ctx):
    tr = recorded(ctx, NAME)
    if tr is not None:
        print("counters in the slice: " + ", ".join(
            f"{k} {tr.counts.get(k)}" for k in SHOWN),
            file=sys.stderr, flush=True)
    return ms_per(ctx, NAME, SPANS, COUNTER)

"""``odometry_graph_replay_pct``: the share of the LiDAR odometry's sweeps
(``odometry.sweeps``: a sweep of all lanes counts once) in the profiler
slice that replayed a captured chain of CUDA graphs
(``odometry.graph_replays``), in %. The reader prints the captures made
inside the slice (``odometry.graph_captures``; 0 when set-up captured
every key) to standard error. A program without the counter gives nothing
to read."""

from __future__ import annotations

import sys

from ._spans import observe, recorded  # noqa: F401  (observe: the hook)

NAME = "odometry_graph_replay_pct"


def read(ctx):
    tr = recorded(ctx, NAME)
    if tr is None:
        return None
    sweeps = tr.counts.get("odometry.sweeps")
    replays = tr.counts.get("odometry.graph_replays")
    if not sweeps or replays is None:
        return None
    print(f"odometry graph captures in the slice: "
          f"{tr.counts.get('odometry.graph_captures', 0)}",
          file=sys.stderr, flush=True)
    return 100.0 * replays / sweeps

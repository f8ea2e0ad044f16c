"""``engine_graph_replay_pct``: the share of the fusion engine's event steps
(``engine.steps``: a step of all lanes counts once) in the profiler slice
that replayed a captured CUDA graph (``engine.graph_replays``), in %. The
reader prints the captures made inside the slice (``engine.graph_captures``;
0 when set-up captured every step) to standard error. A program without
the counter gives nothing to read."""

from __future__ import annotations

import sys

from ._spans import observe, recorded  # noqa: F401  (observe: the hook)

NAME = "engine_graph_replay_pct"


def read(ctx):
    tr = recorded(ctx, NAME)
    if tr is None:
        return None
    steps = tr.counts.get("engine.steps")
    replays = tr.counts.get("engine.graph_replays")
    if not steps or replays is None:
        return None
    print(f"engine graph captures in the slice: "
          f"{tr.counts.get('engine.graph_captures', 0)}",
          file=sys.stderr, flush=True)
    return 100.0 * replays / steps

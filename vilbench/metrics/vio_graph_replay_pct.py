"""``vio_graph_replay_pct``: the share of the VIO EKF's frames
(``vio.frames``: a frame of all lanes counts once) in the profiler slice
that replayed the captured CUDA graph of the frame step
(``vio.graph_replays``), in %. The reader prints the captures made inside
the slice (``vio.graph_captures``; 0 when set-up captured every key) to
standard error. A program without the counter gives nothing to read."""

from __future__ import annotations

import sys

from ._spans import observe, recorded  # noqa: F401  (observe: the hook)

NAME = "vio_graph_replay_pct"


def read(ctx):
    tr = recorded(ctx, NAME)
    if tr is None:
        return None
    frames = tr.counts.get("vio.frames")
    replays = tr.counts.get("vio.graph_replays")
    if not frames or replays is None:
        return None
    print(f"vio graph captures in the slice: "
          f"{tr.counts.get('vio.graph_captures', 0)}",
          file=sys.stderr, flush=True)
    return 100.0 * replays / frames

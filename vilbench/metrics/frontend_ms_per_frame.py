"""``frontend_ms_per_frame``: the tracker's spans in the profiler slice
(``frontend.pyramids``, ``frontend.candidates``, ``frontend.track``:
``frontends/vio/frontend``'s ``pyramids_batch``, ``candidates_batch``,
``track_frames``), in ms per tracked frame (``frontend.frames``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("frontend.pyramids", "frontend.candidates", "frontend.track")
COUNTER = "frontend.frames"


def read(ctx):
    return ms_per(ctx, "frontend_ms_per_frame", SPANS, COUNTER)

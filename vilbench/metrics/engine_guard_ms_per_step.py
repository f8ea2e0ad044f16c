"""``engine_guard_ms_per_step``: the engine's ``engine.guard`` spans
(the health check and the guarded update of each event) in the profiler
slice, in ms per event step (``engine.steps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("engine.guard",)
COUNTER = "engine.steps"


def read(ctx):
    return ms_per(ctx, "engine_guard_ms_per_step", SPANS, COUNTER)

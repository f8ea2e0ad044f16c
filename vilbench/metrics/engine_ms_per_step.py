"""``engine_ms_per_step``: the fusion engine's ``engine.run`` span
(``fusion/engine.run`` or ``run_lanes``) in the profiler slice, in ms per
event step (``engine.steps``: a step of all lanes counts once)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("engine.run",)
COUNTER = "engine.steps"


def read(ctx):
    return ms_per(ctx, "engine_ms_per_step", SPANS, COUNTER)

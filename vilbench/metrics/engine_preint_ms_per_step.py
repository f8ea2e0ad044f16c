"""``engine_preint_ms_per_step``: the engine's ``engine.preintegrate``
spans (the IMU window's preintegration of each event) in the profiler
slice, in ms per event step (``engine.steps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("engine.preintegrate",)
COUNTER = "engine.steps"


def read(ctx):
    return ms_per(ctx, "engine_preint_ms_per_step", SPANS, COUNTER)

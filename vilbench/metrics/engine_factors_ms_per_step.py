"""``engine_factors_ms_per_step``: the engine's ``engine.factors``
spans (from ``add_keyframe``, the Schur eviction, through ``add_unary``,
the odometry delta and covariance included) in the profiler slice, in ms
per event step (``engine.steps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("engine.factors",)
COUNTER = "engine.steps"


def read(ctx):
    return ms_per(ctx, "engine_factors_ms_per_step", SPANS, COUNTER)

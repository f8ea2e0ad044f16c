"""``engine_solve_ms_per_step``: the ``smoother.solve`` spans (the
Gauss-Newton solves, their assembly included) in the profiler slice, in ms
per event step (``engine.steps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("smoother.solve",)
COUNTER = "engine.steps"


def read(ctx):
    return ms_per(ctx, "engine_solve_ms_per_step", SPANS, COUNTER)

"""``engine_assemble_ms_per_step``: the ``smoother.assemble``
spans (each Gauss-Newton iteration's ``_assemble`` of H and b) in the
profiler slice, in ms per event step (``engine.steps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("smoother.assemble",)
COUNTER = "engine.steps"


def read(ctx):
    return ms_per(ctx, "engine_assemble_ms_per_step", SPANS, COUNTER)

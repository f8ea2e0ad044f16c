"""``vil_vio_ms_per_frame``: ``run_vil``'s VIO stage (the ``vil.vio`` span
of ``fusion/vil.run_vil``: the EKF over every frame) in the profiler
slice, in ms per frame (``vio.frames``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("vil.vio",)
COUNTER = "vio.frames"


def read(ctx):
    return ms_per(ctx, "vil_vio_ms_per_frame", SPANS, COUNTER)

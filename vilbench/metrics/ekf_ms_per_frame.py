"""``ekf_ms_per_frame``: the VIO EKF's ``vio.run`` span
(``frontends/vio/pipeline.run``) in the profiler slice, in ms per frame
(``vio.frames``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("vio.run",)
COUNTER = "vio.frames"


def read(ctx):
    return ms_per(ctx, "ekf_ms_per_frame", SPANS, COUNTER)

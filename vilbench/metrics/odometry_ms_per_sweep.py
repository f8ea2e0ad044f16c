"""``odometry_ms_per_sweep``: the LiDAR odometry's ``odometry.run``
span (``frontends/lidar/odometry.run``) in the profiler slice, in ms per
sweep (``odometry.sweeps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("odometry.run",)
COUNTER = "odometry.sweeps"


def read(ctx):
    return ms_per(ctx, "odometry_ms_per_sweep", SPANS, COUNTER)

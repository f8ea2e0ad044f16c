"""``vil_lidar_ms_per_sweep``: ``run_vil``'s LiDAR stage (the ``vil.lidar``
span of ``fusion/vil.run_vil``: the registration priors and
``odometry.run``) in the profiler slice, in ms per sweep
(``odometry.sweeps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("vil.lidar",)
COUNTER = "odometry.sweeps"


def read(ctx):
    return ms_per(ctx, "vil_lidar_ms_per_sweep", SPANS, COUNTER)

"""``icp_ms_per_sweep``: the ``icp.register`` spans (each ICP
registration of an odometry step: scan to scan, then scan to map) in the
profiler slice, in ms per sweep (``odometry.sweeps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("icp.register",)
COUNTER = "odometry.sweeps"


def read(ctx):
    return ms_per(ctx, "icp_ms_per_sweep", SPANS, COUNTER)

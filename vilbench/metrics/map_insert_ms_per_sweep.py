"""``map_insert_ms_per_sweep``: the ``voxelmap.insert`` spans (the
corner and surface maps' ``insert_auto`` of an odometry step) in the
profiler slice, in ms per sweep (``odometry.sweeps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("voxelmap.insert",)
COUNTER = "odometry.sweeps"


def read(ctx):
    return ms_per(ctx, "map_insert_ms_per_sweep", SPANS, COUNTER)

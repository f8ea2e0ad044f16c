"""``lidar_ms_per_sweep``: the ``lidar`` stage span's wall over the window
before the profiler slice, in ms per sweep (per batched sweep of all
lanes)."""


def read(ctx):
    n = ctx.counts.get("sweep", 0)
    if "lidar" not in ctx.spans or not n:
        return None
    return 1e3 * ctx.spans["lidar"] / n

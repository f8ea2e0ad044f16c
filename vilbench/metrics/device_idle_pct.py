"""``device_idle_pct``: the share of the profiler slice's wall in which no
operation ran on the card, in %."""

from .. import trace


def read(ctx):
    if not ctx.slice.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ctx.slice) / ctx.slice.wall_s)

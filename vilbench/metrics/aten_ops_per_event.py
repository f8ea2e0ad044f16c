"""``aten_ops_per_event``: the outermost host-side ``aten::`` ops the
profiler recorded in its slice (an op inside another op's interval is that
op's own work and not counted), per fused odometry event completed there:
the eager dispatch every stage pays."""


def read(ctx):
    if not ctx.slice.events:
        return None
    ops = sorted((s, e) for _, s, e in ctx.slice.cpu_ops)
    n, end = 0, float("-inf")
    for s, e in ops:
        if s >= end:
            n, end = n + 1, e
    return n / ctx.slice.events

"""``idle_outside_spans_pct``: of the profiler slice's device-idle time
(from its first to its last recorded event, less the union of device
activity), the share in which no program span was open, in %: the idle
time that the program's stages cannot account for (the harness, the
cell's code between units, the profiler). Also prints to standard error the
device-idle seconds by the innermost program span open when each idle
stretch began. Nothing to read without device activity."""

from ._spans import (idle_intervals, merged, observe, overlap,  # noqa: F401
                     print_idle_split, recorded)

NAME = "idle_outside_spans_pct"


def read(ctx):
    tr = recorded(ctx, NAME)
    if tr is None or not tr.spans or not ctx.slice.device_ops:
        return None
    idle = idle_intervals(ctx.slice)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    print_idle_split(idle, tr.spans)
    inside = overlap(idle, merged((s.start, s.end) for s in tr.spans))
    return 100.0 * (total - inside) / total

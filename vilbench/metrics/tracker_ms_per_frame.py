"""``tracker_ms_per_frame``: the tracker's stage spans (``frontend_pyr``,
``frontend_detect``, ``frontend_track``) over the window before the
profiler slice, in ms per frame (per batched frame of all lanes)."""

STAGES = ("frontend_pyr", "frontend_detect", "frontend_track")


def read(ctx):
    n = ctx.counts.get("frame", 0)
    if not n or not all(s in ctx.spans for s in STAGES):
        return None
    return 1e3 * sum(ctx.spans[s] for s in STAGES) / n

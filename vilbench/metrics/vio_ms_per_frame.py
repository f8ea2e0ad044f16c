"""``vio_ms_per_frame``: the ``vio`` stage span's wall over the window before
the profiler slice, in ms per frame (per batched frame of all lanes)."""


def read(ctx):
    n = ctx.counts.get("frame", 0)
    if "vio" not in ctx.spans or not n:
        return None
    return 1e3 * ctx.spans["vio"] / n

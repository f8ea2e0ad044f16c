"""``fusion_ms_per_step``: the ``fusion`` stage span's wall over the
window before the profiler slice, in ms per step (per batched step of all
lanes)."""


def read(ctx):
    n = ctx.counts.get("step", 0)
    if "fusion" not in ctx.spans or not n:
        return None
    return 1e3 * ctx.spans["fusion"] / n

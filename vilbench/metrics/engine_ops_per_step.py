"""``engine_ops_per_step``: the engine's dispatch count: the outermost
host-side ``aten::`` ops of the profiler slice (as ``aten_ops_per_event``
counts them) that start inside an ``engine.run`` span, per event step
(``engine.steps``: a step of all lanes counts once)."""

from ._spans import observe, outermost, merged, recorded  # noqa: F401

NAME = "engine_ops_per_step"


def read(ctx):
    tr = recorded(ctx, NAME)
    steps = tr.counts.get("engine.steps") if tr is not None else None
    if not steps or not ctx.slice.cpu_ops:
        return None
    runs = merged((s.start, s.end) for s in tr.spans if s.name == "engine.run")
    if not runs:
        return None
    n, k = 0, 0
    for s, _ in outermost(ctx.slice.cpu_ops):
        while k < len(runs) and runs[k][1] < s:
            k += 1
        if k < len(runs) and runs[k][0] <= s:
            n += 1
    return n / steps

"""``vil_timeline_ms_per_run``: ``run_vil``'s host handoff (the
``vil.timeline`` span of ``fusion/vil.run_vil``: the front ends' outputs
brought to the host, merged into one timeline and put back on the device)
in the profiler slice, in ms per call (``vil.runs``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("vil.timeline",)
COUNTER = "vil.runs"


def read(ctx):
    return ms_per(ctx, "vil_timeline_ms_per_run", SPANS, COUNTER)

"""The program's own spans and counters over the profiler slice, for the
span metrics (not a metric itself).

:func:`observe` is each span reader's hook, held open by the harness over
the slice: it opens the program's recorder (``utils.tracing.recording``;
the readers join one recording) and notes it. When the last reader's hook
closes, the recording holds every span the slice's units ran, with start
and end in seconds on the profiler's clock (the numbers the slice keeps
for its host and device ops), and each counter's total. A program without
the recorder records nothing, and its readers read nothing. Counts are of
calls as the program makes them: under ``torch.func.vmap`` a step or a
frame of all lanes counts once."""

from __future__ import annotations

import contextlib
import sys

from .. import trace as TR


@contextlib.contextmanager
def observe(noted: list):
    try:
        from vil_sensor_fusion_tpu_torch.utils.tracing import recording
    except ImportError:
        yield
        return
    with recording() as rec:
        yield
    noted.append(rec)


def recorded(ctx, metric: str):
    """The recording ``metric``'s hook noted (a ``utils.tracing.Trace``),
    or ``None``."""
    noted = ctx.observed.get(metric) or []
    return noted[0].trace if noted else None


def ms_per(ctx, metric: str, names, counter: str):
    """Σ walls of the spans named in ``names``, in ms, per ``counter``;
    ``None`` without such a span or count."""
    tr = recorded(ctx, metric)
    if tr is None or not tr.counts.get(counter):
        return None
    walls = [s.end - s.start for s in tr.spans if s.name in names]
    if not walls:
        return None
    return 1e3 * sum(walls) / tr.counts[counter]


def outermost(ops) -> list[tuple[float, float]]:
    """The ``(start, end)`` of the ops not inside another op's interval
    (``aten_ops_per_event``'s count)."""
    out, end = [], float("-inf")
    for s, e in sorted((s, e) for _, s, e in ops):
        if s >= end:
            out.append((s, e))
            end = e
    return out


def merged(intervals) -> list[tuple[float, float]]:
    return TR.merged_intervals(("", s, e) for s, e in intervals)


def idle_intervals(sl) -> list[tuple[float, float]]:
    """The slice's device-idle time as sorted disjoint intervals: from its
    first to its last recorded event, less the union of device activity."""
    busy = TR.merged_intervals(sl.device_ops)
    edges = [x for _, s, e in sl.cpu_ops + sl.labels for x in (s, e)]
    lo = min(edges + [busy[0][0]])
    hi = max(edges + [busy[-1][1]])
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    return idle


def overlap(a, b) -> float:
    """Seconds shared by two lists of sorted disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost_at(spans, times) -> list:
    """For each of the ascending ``times``, the name of the innermost span
    open then, or ``None``. Spans nest, so the open span that began last
    is the innermost."""
    order = sorted(range(len(spans)), key=lambda k: spans[k].start)
    stack, j, out = [], 0, []
    for t in times:
        while j < len(order) and spans[order[j]].start <= t:
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]].end <= t:
            stack.pop()
        out.append(spans[stack[-1]].name if stack else None)
    return out


def print_idle_split(idle, spans) -> None:
    """Standard error: the device-idle seconds that began under each
    innermost program span (``outside spans`` where none was open)."""
    per: dict[str, float] = {}
    for (s, e), name in zip(idle, innermost_at(spans, [s for s, _ in idle])):
        key = name or "outside spans"
        per[key] = per.get(key, 0.0) + (e - s)
    rows = sorted(per.items(), key=lambda kv: -kv[1])
    print("device idle by innermost program span (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rows),
          file=sys.stderr, flush=True)

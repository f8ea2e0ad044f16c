"""The profiler slice of a traced run: ``torch.profiler`` over a few whole
units at the end of the window, host ops with their input shapes and the
card's activity, read from the profiler's raw event list (no per-event
Python objects are built).

Times are in seconds. ``cpu_ops`` (``aten::`` ops only) are
``(name, start, end)``,
``device_ops`` ``(name, start, end)``; both share the profiler's clock.
``labels`` are the stage names the span recorder put in the trace.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import torch

from .harness import Spans


def profile_slice(cell, sync, cuda: bool, log=None,
                  observers=()) -> SimpleNamespace:
    """Profile ``cell.trace_units`` whole units, with each of
    ``observers`` (context managers) open around them. Keeps the host's
    ``aten::`` ops and the recorder's stage labels, and every device
    operation. Input shapes are not recorded: they would double the
    slice's cost."""
    log = log or (lambda msg: None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rec = Spans(label=True)
    units = []
    t_on = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for obs in observers:
            stack.enter_context(obs)
        prof = stack.enter_context(torch.profiler.profile(activities=acts))
        t0 = time.perf_counter()
        for _ in range(cell.trace_units):
            units.append(cell.unit(rec))
        sync()
        wall = time.perf_counter() - t0
    t_read = time.perf_counter()
    stages = frozenset(cell.stage_names)
    host = torch.autograd.DeviceType.CPU
    cpu_ops, device_ops, labels = [], [], []
    events = prof.profiler.kineto_results.events()
    for e in events:
        name = e.name()
        if e.device_type() == host:
            if name.startswith("aten::"):
                s = e.start_ns()
                cpu_ops.append((name, s * 1e-9, (s + e.duration_ns()) * 1e-9))
            elif name in stages:       # the recorder's stage labels
                s = e.start_ns()
                labels.append((name, s * 1e-9, (s + e.duration_ns()) * 1e-9))
        elif name not in stages:
            s = e.start_ns()
            device_ops.append((name, s * 1e-9, (s + e.duration_ns()) * 1e-9))
    n_events = len(events)
    del events, prof
    t_done = time.perf_counter()
    log(f"profiler: start {t0 - t_on:.1f} s, units {wall:.1f} s, stop "
        f"{t_read - t0 - wall:.1f} s, read {t_done - t_read:.1f} s of "
        f"{n_events} events")
    return SimpleNamespace(
        units=len(units), events=cell.events_per_unit * len(units),
        wall_s=wall, cpu_ops=cpu_ops, device_ops=device_ops, labels=labels,
        read_s=t_done - t_read)


def merged_intervals(ops) -> list[tuple[float, float]]:
    """The union of ``(name, start, end)`` intervals, as sorted disjoint
    ``(start, end)`` pairs."""
    out: list[list[float]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(sl) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in merged_intervals(sl.device_ops))


def breakdown(sl, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps between
    device activity summed by what the host was doing when each began: the
    stage and the outermost host op open at that moment."""
    per_op: dict[str, float] = {}
    for name, s, e in sl.device_ops:
        per_op[name] = per_op.get(name, 0.0) + (e - s)
    busy = merged_intervals(sl.device_ops)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    ops = sorted(((s, e, n) for n, s, e in sl.cpu_ops), key=lambda o: o[0])
    labels = sorted((s, e, n) for n, s, e in sl.labels)
    per_gap: dict[str, float] = {}
    i_op = i_lab = 0
    open_op = open_lab = None
    for g0, g1 in gaps:
        while i_op < len(ops) and ops[i_op][0] <= g0:
            if open_op is None or ops[i_op][0] >= open_op[1]:
                open_op = ops[i_op]
            i_op += 1
        while i_lab < len(labels) and labels[i_lab][0] <= g0:
            open_lab = labels[i_lab]
            i_lab += 1
        op = open_op[2] if open_op and open_op[1] >= g0 else "host"
        lab = open_lab[2] if open_lab and open_lab[1] >= g0 else "harness"
        key = f"{lab}/{op}"
        per_gap[key] = per_gap.get(key, 0.0) + (g1 - g0)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": top_of(per_op), "idle_gaps": top_of(per_gap)}

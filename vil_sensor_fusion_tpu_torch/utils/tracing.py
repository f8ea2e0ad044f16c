"""Tracing / profiling.

Port of ``vil_sensor_fusion_tpu/utils/tracing.py`` onto ``torch.profiler``:

- :func:`span`, :func:`count` — the program's own recorder: named, nested
  regions and integer counters placed in the stage functions, recorded
  only while :func:`recording` is open.
- :func:`device_trace` — context manager that profiles the host and, for a
  CUDA device, the card, and writes a Chrome trace with the program's
  spans on a track of their own to a log directory.
- :class:`StageTimer` — wall-clock stage timing that waits for the device
  work a stage launched, exportable as JSON.

The recorder is off unless a :func:`recording` is open; off, a span or a
counter costs one test of a module flag. On, a span reads the host clock
twice and appends to lists: no device sync, no tensor op and nothing that
enters the profiler (a ``record_function`` range would show up among a
CUDA trace's device events). Span times are on the clock of
``torch.profiler``'s events (``start_ns()``: Unix time in ns, as
``time.time_ns`` reads it), in seconds, so a span can be laid over the
host and device ops of a profile taken at the same time. Inside
``torch.func.vmap`` a span or a counter fires once per batched call. The
recorder serves the thread that opened the recording.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, NamedTuple

import torch

from .. import DEFAULT_DEVICE, _tree


class Span(NamedTuple):
    """One recorded span: start and end in seconds on the profiler's
    clock; ``parent`` and ``root`` index the recording's spans (``parent``
    is -1 for a root; a root's ``root`` is its own index)."""

    name: str
    start: float
    end: float
    parent: int
    root: int


class Trace(NamedTuple):
    """A finished recording: its spans in the order they began, and each
    counter's total."""

    spans: List[Span]
    counts: Dict[str, int]


class Recording:
    """What :func:`recording` yields: its :attr:`trace` is ``None`` until
    the last reader closes the recording."""

    def __init__(self):
        self.trace: Trace | None = None
        # Each span as [name, start ns, end ns, parent, root].
        self._spans: List[list] = []
        self._open: List[int] = []
        self._counts: Dict[str, int] = {}
        self._readers = 0

    def _begin(self, name: str) -> "Recording":
        i = len(self._spans)
        parent = self._open[-1] if self._open else -1
        root = self._spans[parent][4] if parent >= 0 else i
        self._spans.append([name, time.time_ns(), 0, parent, root])
        self._open.append(i)
        return self

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        self._spans[self._open.pop()][2] = time.time_ns()
        return False

    def _finish(self) -> None:
        stop = time.time_ns()
        for i in self._open:           # spans still open end at the stop
            self._spans[i][2] = stop
        self.trace = Trace(
            spans=[Span(n, s * 1e-9, e * 1e-9, p, r)
                   for n, s, e, p, r in self._spans],
            counts=dict(self._counts))


# The open recording, or None: the recorder's on/off flag. One per process,
# since the spans sit in library functions that no caller hands a recorder.
_REC: Recording | None = None
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records the enclosed work as a span while a
    recording is open; otherwise it does nothing."""
    if _REC is None:
        return _OFF
    return _REC._begin(name)


def count(name: str, n: int) -> None:
    """Add the host-known integer ``n`` to counter ``name`` while a
    recording is open."""
    if _REC is not None:
        _REC._counts[name] = _REC._counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the enclosed work and yield the
    :class:`Recording`. Nested calls join the recording already open and
    yield it too, so several readers observe one recording at the cost of
    one; it stops, and its ``trace`` is set, when the outermost closes."""
    global _REC
    if _REC is None:
        _REC = Recording()
    rec = _REC
    rec._readers += 1
    try:
        yield rec
    finally:
        rec._readers -= 1
        if rec._readers == 0:
            _REC = None
            rec._finish()


def _add_spans(path: str, trace: Trace) -> None:
    """Write ``trace``'s spans into the Chrome trace at ``path`` as a
    process of their own ("program spans", one track), on the trace's own
    time base, and its counters under ``programCounts``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    base_us = doc.get("baseTimeNanoseconds", 0) * 1e-3
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for i, s in enumerate(trace.spans):
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": 0, "ts": s.start * 1e6 - base_us,
                       "dur": (s.end - s.start) * 1e6,
                       "args": {"id": i, "parent": s.parent,
                                "root": s.root}})
    doc["programCounts"] = trace.counts
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def device_trace(log_dir: str, device=DEFAULT_DEVICE):
    """Profile the enclosed work — host ops, and the card's kernels when
    ``device`` is a CUDA device — while recording the program's spans, and
    write ``log_dir/trace.json`` (Chrome trace format) at exit, the spans
    as their own track on the profiler's clock. Yields the profiler
    (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, rec.trace)


def block_until_ready(value: Any) -> Any:
    """Wait until the device work producing ``value``'s tensors is done:
    synchronise each CUDA device that holds one of its tensors."""
    devices = {x.device for x in _tree.tree_leaves(value)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return value


class StageOutput:
    """Mutable holder yielded by :meth:`StageTimer.stage`: the stage body
    assigns the value(s) it launches to ``.value`` and the timer waits for
    them when the stage exits, so asynchronous device work dispatched
    *inside* the block is attributed to the stage that launched it."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Any = None


class StageTimer:
    """Accumulates per-stage wall times. ``stage`` yields a
    :class:`StageOutput`; set ``.value`` to the stage's device output and the
    timer waits for it at exit (plus any ``block_on`` value)."""

    def __init__(self):
        self._records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None):
        holder = StageOutput()
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            block_until_ready(holder.value)
            block_until_ready(block_on)
            self._records.setdefault(name, []).append(
                time.perf_counter() - t0)

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn``, wait for its result's device work, record the wall
        time."""
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self._records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self._records.items():
            n = len(times)
            total = sum(times)
            out[name] = {
                "calls": n,
                "total_s": total,
                "mean_s": total / n,
                "min_s": min(times),
                "max_s": max(times),
            }
        return out

    def json(self) -> str:
        return json.dumps(self.summary(), indent=2, sort_keys=True)

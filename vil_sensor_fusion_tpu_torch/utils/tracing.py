"""Tracing / profiling.

Port of ``vil_sensor_fusion_tpu/utils/tracing.py`` onto ``torch.profiler``:

- :func:`annotate` — a named region (``torch.profiler.record_function``)
  that shows up in profiler traces.
- :func:`device_trace` — context manager that profiles the host and, for a
  CUDA device, the card, and writes a Chrome trace to a log directory.
- :class:`StageTimer` — wall-clock stage timing that waits for the device
  work a stage launched, exportable as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List

import torch

from .. import DEFAULT_DEVICE, _tree


@contextlib.contextmanager
def annotate(name: str):
    """Named region that appears in profiler traces."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str, device=DEFAULT_DEVICE):
    """Profile the enclosed work — host ops, and the card's kernels when
    ``device`` is a CUDA device — and write ``log_dir/trace.json`` (Chrome
    trace format) at exit. Yields the profiler (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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

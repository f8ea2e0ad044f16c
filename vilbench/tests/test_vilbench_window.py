"""The window's arithmetic: every event of the completed units over the
time to the end of the last unit, no unit started after the window, the
90th percentile over every unit, the check's worst reading per number."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from vilbench import harness
from vilbench.metrics import aten_ops_per_event, device_idle_pct


class Clocked:
    """Units of fixed lengths on a fake clock."""

    events_per_unit = 3

    def __init__(self, lengths, clock):
        self.lengths, self.clock, self.i = list(lengths), clock, 0

    def unit(self, rec):
        dt = self.lengths[self.i % len(self.lengths)]
        self.clock.t += dt
        self.i += 1
        return {"latency_s": dt, "counts": {"step": 3}}


def test_rate_is_all_events_over_time_to_the_last_unit(monkeypatch):
    clock = SimpleNamespace(t=100.0)
    monkeypatch.setattr(time, "perf_counter", lambda: clock.t)
    cell = Clocked([2.0, 3.0, 4.0], clock)
    w = harness.window(cell, 6.0, harness.Spans())
    # Units end at 2, 5 and 9 s: the third starts before 6 s and is whole.
    assert w["units"] == 3 and w["events"] == 9
    assert w["elapsed_s"] == pytest.approx(9.0)
    assert w["events_per_s"] == pytest.approx(1.0)
    assert w["counts"] == {"step": 9}
    assert w["update_p90_s"] == pytest.approx(3.8)


def test_no_unit_starts_after_the_window(monkeypatch):
    clock = SimpleNamespace(t=0.0)
    monkeypatch.setattr(time, "perf_counter", lambda: clock.t)
    w = harness.window(Clocked([1.0], clock), 3.0, harness.Spans())
    assert w["units"] == 3 and w["elapsed_s"] == pytest.approx(3.0)


def test_p90_is_linear_between_order_statistics():
    assert harness.p90(list(range(1, 11))) == pytest.approx(9.1)


def test_judge_keeps_each_numbers_worst_and_counts_failed_units():
    checks, failed = harness.judge(
        [{"a": 0.1, "b": 0.0}, {"a": 0.3, "b": 2.0}, {"a": float("nan"),
                                                      "b": 0.0}],
        {"a": 0.2, "b": 1.0})
    assert failed == 2
    assert checks["b"] == {"value": 2.0, "limit": 1.0}
    assert checks["a"]["value"] != checks["a"]["value"]     # NaN kept


def test_slice_readers():
    sl = SimpleNamespace(
        events=2, wall_s=10.0,
        cpu_ops=[("aten::mm", 0.0, 2.0), ("aten::add", 0.5, 1.0),
                 ("aten::add", 3.0, 4.0)],
        device_ops=[("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("k3", 8.0, 9.0)])
    ctx = SimpleNamespace(slice=sl)
    assert aten_ops_per_event.read(ctx) == pytest.approx(1.0)
    assert device_idle_pct.read(ctx) == pytest.approx(60.0)


def test_judge_pools_median_numbers_over_every_unit():
    readings = [{"m_median": [0.0, 0.1, 5.0]}, {"m_median": [0.2, 0.3]}]
    checks, failed = harness.judge(readings, {"m_median": 0.25})
    assert checks["m_median"] == {"value": 0.2, "limit": 0.25}
    assert failed == 0
    checks, failed = harness.judge(readings, {"m_median": 0.15})
    assert failed == 2

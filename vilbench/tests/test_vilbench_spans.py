"""The span readers (``metrics/_spans.py`` and the metrics on top of it): on
a CPU ``--trace 1`` run of each tiny cell every span reader reads a number
and the engine's phases account for its span; the idle split on a slice
made by hand; and a program without the recorder gives nothing to read,
without raising."""

from __future__ import annotations

import builtins
from types import SimpleNamespace

import pytest
import torch

from vilbench import harness
from vilbench.tests.vilbench_tiny import LANES, REPO, STREAM, make_root
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

SPAN_READERS = (
    "frontend_ms_per_frame", "ekf_ms_per_frame", "odometry_ms_per_sweep",
    "icp_ms_per_sweep", "map_insert_ms_per_sweep", "engine_ms_per_step",
    "engine_preint_ms_per_step", "engine_factors_ms_per_step",
    "engine_solve_ms_per_step", "engine_assemble_ms_per_step",
    "engine_guard_ms_per_step", "engine_ops_per_step")
PHASES = ("engine_preint_ms_per_step", "engine_factors_ms_per_step",
          "engine_solve_ms_per_step", "engine_guard_ms_per_step")


def _reader(name):
    return harness.load_module(REPO / "vilbench", "metrics", name)


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("spans"))
    return {cell: harness.run(cell, 2**31 + 4242, 0.01, True, "cpu",
                              root=root)[0]
            for cell in (LANES, STREAM)}


@pytest.mark.parametrize("cell", [LANES, STREAM])
def test_every_span_reader_reads_a_tiny_cell(lines, cell):
    line = lines[cell]
    assert line["correct"] is True
    got = line["metrics"]
    for name in SPAN_READERS:
        assert got[name]["value"] > 0, name
    engine = got["engine_ms_per_step"]["value"]
    phases = sum(got[p]["value"] for p in PHASES)
    assert 0.9 * engine <= phases <= engine
    assert (got["engine_assemble_ms_per_step"]["value"]
            <= got["engine_solve_ms_per_step"]["value"])
    assert (got["icp_ms_per_sweep"]["value"]
            + got["map_insert_ms_per_sweep"]["value"]
            <= got["odometry_ms_per_sweep"]["value"])
    # No device on the CPU: no device idle time to split.
    assert "idle_outside_spans_pct" not in got


def _slice(cpu_ops, device_ops):
    return SimpleNamespace(cpu_ops=cpu_ops, device_ops=device_ops,
                           labels=[], events=1, wall_s=1.0)


def _recording(spans, counts):
    return SimpleNamespace(trace=TR.Trace([TR.Span(*s) for s in spans],
                                          counts))


def test_the_idle_split_on_a_slice_by_hand(capsys):
    """Host ops from 0 to 10 s, the device busy 1-2 and 5-6; spans: root
    0.5-7 with a child 4-6.5. Idle 0-1, 2-5, 6-10 (8 s); outside spans
    0-0.5 and 7-10 (3.5 s)."""
    sl = _slice([("aten::mul", 0.0, 0.1), ("aten::add", 9.9, 10.0)],
                [("k", 1.0, 2.0), ("k", 5.0, 6.0)])
    rec = _recording([("root", 0.5, 7.0, -1, 0), ("child", 4.0, 6.5, 0, 0)],
                     {})
    ctx = SimpleNamespace(slice=sl,
                          observed={"idle_outside_spans_pct": [rec]})
    assert _reader("idle_outside_spans_pct").read(ctx) == pytest.approx(
        100.0 * 3.5 / 8.0)
    err = capsys.readouterr().err
    # Idle stretches by where they began: 0 outside, 2 under root, 6 under
    # child.
    assert "child 4.0000" in err and "root 3.0000" in err
    assert "outside spans 1.0000" in err


def test_engine_ops_count_the_outermost_ops_inside_engine_run():
    sl = _slice([("aten::a", 0.0, 1.0), ("aten::b", 0.2, 0.5),
                 ("aten::c", 2.0, 2.1), ("aten::d", 2.5, 2.6),
                 ("aten::e", 4.0, 4.1)], [])
    rec = _recording([("engine.run", 1.9, 3.0, -1, 0)],
                     {"engine.steps": 2})
    ctx = SimpleNamespace(slice=sl, observed={"engine_ops_per_step": [rec]})
    assert _reader("engine_ops_per_step").read(ctx) == 1.0


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    real = builtins.__import__

    def no_recorder(name, globals=None, locals=None, fromlist=(), level=0):
        if name.endswith("utils.tracing") and "recording" in (fromlist or ()):
            raise ImportError("cannot import name 'recording'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_recorder)
    sl = _slice([("aten::a", 0.0, 1.0)], [("k", 0.1, 0.2)])
    for name in SPAN_READERS + ("idle_outside_spans_pct",):
        r = _reader(name)
        noted = []
        with r.observe(noted):
            pass
        assert noted == []
        ctx = SimpleNamespace(slice=sl, observed={name: noted})
        assert r.read(ctx) is None, name

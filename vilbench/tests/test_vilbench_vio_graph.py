"""The ``vio_graph_replay_pct`` reader on recordings made by hand: the
share of the VIO EKF's frames that replayed the captured graph of the
frame step, the captures in the slice on standard error, nothing to read on
the eager path (the counter absent) or without the recorder, and no
reading on a CPU ``--trace 1`` run of each tiny cell, where the VIO EKF
takes its eager step."""

from __future__ import annotations

import builtins
from types import SimpleNamespace

import pytest
import torch

from vilbench import harness
from vilbench.tests.vilbench_tiny import LANES, REPO, STREAM, make_root
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

NAME = "vio_graph_replay_pct"


def _reader():
    return harness.load_module(REPO / "vilbench", "metrics", NAME)


def _ctx(counts):
    trace = TR.Trace([TR.Span("vio.run", 0.0, 1.0, -1, 0)], counts)
    sl = SimpleNamespace(cpu_ops=[], device_ops=[], labels=[], events=1,
                         wall_s=1.0)
    return SimpleNamespace(slice=sl,
                           observed={NAME: [SimpleNamespace(trace=trace)]})


@pytest.mark.parametrize("counts, pct, captures", [
    ({"vio.frames": 12, "vio.graph_replays": 12}, 100.0, 0),
    ({"vio.frames": 5, "vio.graph_replays": 4,
      "vio.graph_captures": 1}, 80.0, 1),
    ({"vio.frames": 1, "vio.graph_replays": 0,
      "vio.graph_captures": 1}, 0.0, 1),
    ({"vio.frames": 12}, None, None),      # the eager step, the parent's
    ({"vio.graph_replays": 3}, None, None)])
def test_vio_graph_replay_pct_reads_the_replay_share(counts, pct,
                                                          captures, capsys):
    assert _reader().read(_ctx(counts)) == pct
    err = capsys.readouterr().err
    if captures is None:
        assert "captures" not in err
    else:
        assert f"vio graph captures in the slice: {captures}" in err


def test_a_program_without_the_recorder_gives_no_replay_share(monkeypatch):
    real = builtins.__import__

    def no_recorder(name, globals=None, locals=None, fromlist=(), level=0):
        if name.endswith("utils.tracing") and "recording" in (fromlist or ()):
            raise ImportError("cannot import name 'recording'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_recorder)
    r = _reader()
    noted = []
    with r.observe(noted):
        pass
    assert noted == []
    ctx = _ctx({})
    ctx.observed[NAME] = noted
    assert r.read(ctx) is None


@pytest.mark.parametrize("cell", [LANES, STREAM])
def test_the_eager_step_on_the_cpu_reports_no_replay_share(tmp_path, cell):
    torch.set_num_threads(2)
    line = harness.run(cell, 2**31 + 4717, 0.01, True, "cpu",
                       root=make_root(tmp_path))[0]
    assert line["correct"] is True
    assert NAME not in line["metrics"]
    assert "ekf_ms_per_frame" in line["metrics"]

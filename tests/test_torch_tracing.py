"""The port's span and counter recorder (``utils.tracing``): off it records
nothing, on it nests spans under their parent and root, adds counters,
fires once per call under ``torch.func.vmap``, shares the profiler's clock
and stays out of the profiler's events; the fusion engine's spans and
counters on a tiny timeline, single sequence and lanes."""

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import _tree
from vil_sensor_fusion_tpu_torch.fusion import engine as E
from vil_sensor_fusion_tpu_torch.graph import smoother as S
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

GN_ITERS = 2
ENGINE_PHASES = {"engine.preintegrate", "engine.factors", "smoother.solve",
                 "smoother.assemble", "engine.guard"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _work():
    with TR.span("outer"):
        TR.count("units", 1)
        with TR.span("inner"):
            TR.count("items", 3)
        with TR.span("inner"):
            TR.count("items", 4)
    with TR.span("second"):
        pass


def test_off_records_nothing():
    assert TR.span("x") is TR.span("y")       # one shared no-op, no object
    _work()                                     # off: nothing kept
    with TR.recording() as rec:
        pass
    _work()
    assert rec.trace == TR.Trace(spans=[], counts={})


def test_nested_spans_carry_parent_and_root():
    with TR.recording() as rec:
        assert rec.trace is None
        _work()
    spans = rec.trace.spans
    assert [s.name for s in spans] == ["outer", "inner", "inner", "second"]
    assert [s.parent for s in spans] == [-1, 0, 0, -1]
    assert [s.root for s in spans] == [0, 0, 0, 3]
    for s in spans:
        assert s.start <= s.end
    assert spans[0].start <= spans[1].start <= spans[2].end <= spans[0].end
    assert spans[3].start >= spans[0].end


def test_counters_add_up():
    with TR.recording() as rec:
        for _ in range(3):
            _work()
    assert rec.trace.counts == {"units": 3, "items": 21}


def test_nested_recordings_share_one():
    with TR.recording() as a:
        with TR.span("before"):
            pass
        with TR.recording() as b:
            _work()
        assert b is a and a.trace is None       # the outer one is still open
        with TR.span("after"):
            pass
    assert [s.name for s in a.trace.spans] == [
        "before", "outer", "inner", "inner", "second", "after"]
    with TR.recording() as c:
        pass
    assert c is not a and c.trace.spans == []


def test_spans_under_vmap_fire_once_per_call():
    def lane(x):
        with TR.span("lane"):
            TR.count("rows", x.shape[0])
            return x * 2.0

    with TR.recording() as rec:
        for _ in range(3):
            torch.func.vmap(lane)(torch.ones(4, 5))
    assert [s.name for s in rec.trace.spans] == ["lane"] * 3
    assert rec.trace.counts == {"rows": 15}


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_a_span_encloses_its_op_on_the_profilers_clock():
    a, b = torch.ones(64, 64), torch.ones(64, 64)
    with TR.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):              # the profiler's first ops
                a @ b
            for _ in range(9):
                with TR.span("matmul"):
                    a @ b
    mm = [(s, e) for n, s, e in _events(prof) if n == "aten::mm"][3:]
    spans = rec.trace.spans
    assert len(mm) == len(spans) == 9
    lead, trail = [], []
    for s, (m0, m1) in zip(spans, mm):
        t0, t1 = round(s.start * 1e9), round(s.end * 1e9)
        assert t0 <= m0 and m1 <= t1            # the span holds its op
        lead.append(m0 - t0)
        trail.append(t1 - m1)
    assert np.median(lead) < 50e3 and np.median(trail) < 50e3   # ns


def test_no_span_enters_the_profiler():
    cfg, es, tl, imu = _engine_case()
    with TR.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            E.run(cfg, es, tl, *imu)
    names = {s.name for s in rec.trace.spans}
    assert ENGINE_PHASES | {"engine.run"} <= names
    assert not names & {n for n, _, _ in _events(prof)}


def _engine_case(lanes=None):
    """A tiny engine run: window 4, ``GN_ITERS`` Gauss-Newton iterations,
    5 events 0.1 s apart with the third (and, in lane 1, the fourth)
    rejected by the gate, IMU at 200 Hz."""
    dt = torch.float32
    cfg = E.FusionConfig(smoother=S.SmootherConfig(window=4,
                                                   gn_iters=GN_ITERS))
    pose0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dt)
    es = E.init(cfg, pose0, torch.zeros(3, dtype=dt),
                torch.zeros(6, dtype=dt), torch.tensor(0.0, dtype=dt))
    times = torch.arange(1, 6, dtype=dt) * 0.1
    poses = pose0.repeat(5, 1)
    poses[:, 4] = times * 2.0
    cov = torch.eye(6, dtype=dt).repeat(5, 1, 1) * 1e-2
    imu_t = torch.arange(0, 121, dtype=dt) / 200.0
    imu_a = torch.tensor([0.0, 0.0, 9.81], dtype=dt).repeat(121, 1)
    imu_g = torch.zeros(121, 3, dtype=dt)

    def timeline(keep):
        return E.Timeline(times=times,
                          source=torch.zeros(5, dtype=torch.int32),
                          odo_pose=poses, odo_cov=cov,
                          keep=torch.tensor(keep, dtype=dt),
                          valid=torch.ones(5, dtype=dt), odo_twist_cov=cov)

    if lanes is None:
        return cfg, es, timeline([1, 1, 0, 1, 1]), (imu_t, imu_a, imu_g)
    tls = [timeline([1, 1, 0, 1, 1]), timeline([1, 1, 0, 0, 1])]
    return (cfg, _tree.tree_map(lambda v: torch.stack([v, v]), es),
            E.Timeline(*[torch.stack(f) for f in zip(*tls)]),
            tuple(torch.stack([x, x]) for x in (imu_t, imu_a, imu_g)))


@pytest.mark.parametrize("lanes", [False, True])
def test_the_engine_records_its_phases(lanes):
    cfg, es, tl, imu = _engine_case(lanes or None)
    with TR.recording() as rec:
        run = E.run_lanes if lanes else E.run
        _, out = run(cfg, es, tl, *imu)
    spans, counts = rec.trace.spans, rec.trace.counts
    solving = 4                  # events where some lane arrives and solves
    assert counts == {"engine.steps": 5}
    assert int(out.solved.reshape(-1, 5).amax(0).sum()) == solving
    runs = [i for i, s in enumerate(spans) if s.name == "engine.run"]
    assert len(runs) == 1 and spans[runs[0]].parent == -1
    names = [s.name for s in spans]
    for phase in ("engine.preintegrate", "engine.factors", "engine.guard"):
        assert names.count(phase) == 5
    solves = [i for i, s in enumerate(spans) if s.name == "smoother.solve"]
    assert len(solves) == solving
    for i in solves:
        kids = [s for s in spans if s.parent == i]
        assert [s.name for s in kids] == ["smoother.assemble"] * GN_ITERS
    for s in spans:
        assert s.name == "engine.run" or (s.name in ENGINE_PHASES
                                          and s.root == runs[0])

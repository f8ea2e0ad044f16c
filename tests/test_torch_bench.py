"""The port's ``cli bench`` (``vil_sensor_fusion_tpu_torch/bench.py``) and
the k-NN routes it batches, on the CPU.

- ``cli bench --device cpu`` at a small rig (160×120 camera, narrow maps,
  2 lanes, 0.3 s, one timed pass; the module's ``RIG`` and ``KNN_SHAPE``
  set small) prints the JSON line of the JAX round's ``bench.py`` with
  finite values, its stderr breakdown names every stage, and the run's
  lanes are sane: finite fused poses, ATEs within the chip check's bounds,
  lane 0 of the batched pass equal to the single-stream run.
- ``torch.func.vmap(ops.knn.knn)`` on CPU tensors equals ``knn_torch`` per
  lane; the custom op's batching rules (the CUDA route under vmap) reach
  the lane entry once per call, with unbatched and nested arguments, and
  give ``knn_torch`` per lane (on the CPU the lane entry is
  ``knn_torch_lanes``).
"""

import contextlib
import io
import json
import warnings

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import bench as B
from vil_sensor_fusion_tpu_torch import cli as TCLI
from vil_sensor_fusion_tpu_torch.ops import knn as K

FALLBACK = ".*performance drop.*batching rule.*"
SMALL_RIG = B.Rig(cam_w=160, cam_h=120, corner_capacity=4096,
                  surf_capacity=8192, submap_corners=512, submap_surfs=1024)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small ops: one intra-op thread runs them as
    fast as eight here and leaves the other cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_bench():
    """One ``cli bench --device cpu`` run at the small rig: its stdout,
    stderr and :class:`bench.BenchResult`."""
    mp = pytest.MonkeyPatch()
    mp.setattr(B, "RIG", SMALL_RIG)
    mp.setattr(B, "KNN_SHAPE", (64, 512))
    seen = {}
    main = B.main
    mp.setattr(B, "main", lambda **kw: seen.setdefault("res", main(**kw)))
    out, err = io.StringIO(), io.StringIO()
    try:
        with warnings.catch_warnings(), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            warnings.filterwarnings("error", message=FALLBACK)
            TCLI.main(["bench", "--device", "cpu", "--lanes", "2",
                       "--duration", "0.3", "--reps", "1"])
    finally:
        mp.undo()
    return out.getvalue(), err.getvalue(), seen["res"]


def test_cli_bench_prints_the_json_line(small_bench):
    stdout, stderr, _ = small_bench
    lines = stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "full_vil_events_per_s_per_chip"
    assert line["unit"] == "events/s"
    diag = json.loads(stderr[stderr.index("{\n"):stderr.rindex("}") + 1])
    events_per_s = diag["events_per_s"]
    assert np.isfinite(events_per_s) and events_per_s > 0
    assert line["value"] == round(events_per_s, 1)
    assert line["vs_baseline"] == round(events_per_s / 150.0, 3)
    assert diag["platform"] == "cpu"
    assert diag["batch_distinct_sequences"] == 2
    assert diag["events_per_lane"] == 9              # 3 sweeps, 6 frames
    stages = ("frontend_pyr", "frontend_detect", "frontend_track", "vio",
              "lidar", "gate", "fusion")
    for key in ("stages_ms_batched", "stages_ms_single"):
        assert set(diag[key]) == set(stages)
        assert all(np.isfinite(v) and v > 0 for v in diag[key].values())
    for key in ("knn_launches_per_pass", "knn_launches_lanes",
                "knn_launches_per_single_pass", "knn_launches_single_stream"):
        assert diag[key] == 0                        # no card, no kernel
    assert set(diag["knn_kernel"]) == {"plain", "library"}
    for key in ("wall_s_per_batched_pass", "events_per_s",
                "single_stream_wall_s", "realtime_factor_single_stream"):
        assert np.isfinite(diag[key]) and diag[key] > 0


def _ate(p, gt):
    return float(np.sqrt(np.mean(np.sum((p[..., 4:] - gt[..., 4:]) ** 2,
                                        axis=-1))))


def test_bench_lanes_are_distinct_sane_and_lane0_is_the_single_run(
        small_bench):
    """Two town worlds as lanes: finite fused poses, VIO / LiDAR ATE <
    0.5 m and fused ATE < 1.0 m per lane (``chip_smoke.py`` phase 11's
    bounds), the LiDAR lanes differ, and lane 0 of the batched pass equals
    lane 0 alone through the single-sequence stage functions (the same
    arithmetic, batched or not: 1e-5 m in f32)."""
    _, _, res = small_bench
    x, o, o1 = res.inputs, res.lanes_out, res.single_out
    assert o.fused.poses.shape == (2, 9, 7)
    assert bool(torch.isfinite(o.fused.poses).all())
    for b in range(2):
        assert _ate(o.vio.pose[b].numpy(), x.gt_vio[b]) < 0.5
        assert _ate(o.lidar.pose[b].numpy(), x.gt_lidar[b]) < 0.5
        assert _ate(o.fused.poses[b].numpy(), x.gt_events[b]) < 1.0
    assert not torch.equal(o.lidar.n_corr[0], o.lidar.n_corr[1])
    for a, c in ((o.vio.pose[0], o1.vio.pose),
                 (o.lidar.pose[0], o1.lidar.pose),
                 (o.fused.poses[0], o1.fused.poses)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(o.gate.keep[0].numpy(),
                                  o1.gate.keep.numpy())


def _knn_inputs(B_, Q, M, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.rand(B_, Q, 3, generator=g) * 40 + 100
    t = torch.rand(B_, M, 3, generator=g) * 40 + 100
    m = (torch.rand(B_, M, generator=g) > 0.2).float()
    m[1, :-1] = 0.0                       # lane 1: one valid target
    return q, t, m


def test_vmap_of_knn_on_cpu_equals_knn_torch_per_lane():
    q, t, m = _knn_inputs(3, 37, 300)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        idx, d2 = torch.func.vmap(K.knn)(q, t, m)
    for b in range(3):
        i1, d1 = K.knn_torch(q[b], t[b], m[b])
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], d1)
    assert bool(torch.isinf(d2[1, :, 1:]).all())     # one valid target
    li, ld = K.knn_torch_lanes(q, t, m)
    assert torch.equal(li, idx) and torch.equal(ld, d2)


@pytest.mark.parametrize("case", ["all_batched", "targets_shared",
                                  "nested"])
def test_custom_op_batching_rules_make_one_lane_call(case, monkeypatch):
    """The CUDA route's batching rule, driven on the CPU with the lane
    entry standing in for its plain twin: each ``vmap`` call of one search
    through the custom op ``knn5`` reaches ``knn_cuda_lanes`` once with
    every argument given a leading lane axis (an unbatched target set
    expanded to every lane; a nested vmap folded into one lane axis), and
    the results equal ``knn_torch`` per lane."""
    calls = []

    def record(q, t, m):
        calls.append((q.shape, t.shape, m.shape))
        return K.knn_torch_lanes(q, t, m)
    monkeypatch.setattr(K, "knn_cuda_lanes", record)
    q, t, m = _knn_inputs(3, 21, 200, seed=1)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        if case == "all_batched":
            idx, d2 = torch.func.vmap(K._knn_op)(q, t, m)
            want = [K.knn_torch(q[b], t[b], m[b]) for b in range(3)]
            shapes = [((3, 21, 3), (3, 200, 3), (3, 200))]
        elif case == "targets_shared":
            idx, d2 = torch.func.vmap(K._knn_op, in_dims=(0, None, None))(
                q, t[0], m[0])
            want = [K.knn_torch(q[b], t[0], m[0]) for b in range(3)]
            shapes = [((3, 21, 3), (3, 200, 3), (3, 200))]
        else:
            q2 = torch.stack([q, q.flip(1)], 1)          # (3, 2, Q, 3)
            idx, d2 = torch.func.vmap(torch.func.vmap(
                K._knn_op, in_dims=(0, None, None)))(q2, t, m)
            idx, d2 = idx.reshape(6, 21, 5), d2.reshape(6, 21, 5)
            want = [K.knn_torch(q2[b, a], t[b], m[b])
                    for b in range(3) for a in range(2)]
            shapes = [((6, 21, 3), (6, 200, 3), (6, 200))]
    assert calls == shapes
    for b, (i1, d1) in enumerate(want):
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], d1)


def test_knn_lane_entries_refuse_before_launching():
    """CPU tensors and wrong shapes or types never reach a launch: the
    lane entry raises, as the single one does (no fallback to the plain
    version for a tensor that is not on the CPU path)."""
    q, t, m = _knn_inputs(2, 8, 16)
    before = K.KERNEL_LAUNCHES
    for bad, err in ((lambda: K.knn_cuda_lanes(q, t, m), ValueError),
                     (lambda: K.knn_cuda_lanes(q.double(), t.double(),
                                               m.double()), TypeError),
                     (lambda: K.knn_cuda_lanes(q, t, m, k=4), ValueError),
                     (lambda: K.knn_cuda_lanes(q[0], t[0], m[0]),
                      ValueError)):
        with pytest.raises(err):
            bad()
    assert K.KERNEL_LAUNCHES == before

"""The fusion engine's captured event steps: on a card, ``fusion/engine.run``
and ``run_lanes`` replay one CUDA graph of the step per solve flag.

On the CPU: when the graph path is taken; the constants hoisted out of the
step equal the values they replace; the step makes no host sync and builds
no tensor from host data (what a capture refuses); and the graph path of
``_cudagraph.scan``, with each replay run as the body it captures, equals
the eager step bit for bit and counts one capture per solve flag (its
first event runs the step eagerly) and one replay per other event.

On the card (marked ``cuda``; skips without one), bit for bit against the
eager step: ``run`` over road-soak chunks with a LiDAR sweep the gate drops
and an event the health guard rejects, ``run_lanes`` over an 8-lane
town-bench pass, ``run`` from a state restored through ``utils.save``, and
two windows in one process. On a machine with an NVIDIA card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_engine_graph.py
"""

import collections
import functools
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu_torch import _consts, _cudagraph, _tree, bench, soak
from vil_sensor_fusion_tpu_torch.core import lie
from vil_sensor_fusion_tpu_torch.core import preintegration as pre
from vil_sensor_fusion_tpu_torch.data import synthetic as syn
from vil_sensor_fusion_tpu_torch.fusion import engine as E
from vil_sensor_fusion_tpu_torch.utils import checkpoint as CK
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

DT = torch.float32
CHUNK = 0.1                   # s: 2 VIO frames and 1 LiDAR sweep
IMU_PER_CHUNK = 90            # soak.py: (chunk + 0.35 s) at 200 Hz


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    """Each test captures its own steps."""
    monkeypatch.setattr(_cudagraph, "_GRAPHS",
                        collections.defaultdict(collections.OrderedDict))


def _entries():
    return list(_cudagraph._GRAPHS["engine"].values())


def _road_cfg(window=6):
    cfg = soak.soak_rig(160, 120, 8).fusion
    return cfg._replace(smoother=cfg.smoother._replace(window=window))


def _chunk(traj, k, g, device, reject=False, unhealthy=False):
    """Chunk ``k`` of a drive as the soak merges it (``chunk_indices``):
    its timeline, and its IMU stream from 0.25 s before it. With
    ``reject`` the gate drops the LiDAR sweep; with ``unhealthy`` the first
    VIO pose is NaN, so the health guard rejects that event."""
    idx = soak.chunk_indices(CHUNK, DT, "cpu")
    times = torch.tensor(k * CHUNK, dtype=DT) + idx.rel_sorted
    odo = syn.sample_odometry(traj, times, trans_noise=0.02, rot_noise=2e-3,
                              generator=g)
    lidar = idx.src == 1
    keep = torch.where(lidar & reject, 0.0, 1.0).to(DT)
    poses = odo.poses.clone()
    if unhealthy:
        poses[int(torch.nonzero(~lidar)[0])] = torch.nan
    imu_t = (torch.tensor(max(0.0, k * CHUNK - 0.25), dtype=DT)
             + torch.arange(IMU_PER_CHUNK, dtype=DT) / 200.0)
    imu = syn.sample_imu(traj, imu_t, accel_noise=0.05, gyro_noise=5e-3,
                         generator=g)
    tl = E.Timeline(times=times, source=idx.src, odo_pose=poses,
                    odo_cov=odo.cov, keep=keep, valid=torch.ones_like(keep),
                    odo_twist_cov=odo.cov * 100.0)
    return _to(tl, device), _to((imu.times, imu.accel, imu.gyro), device)


def _to(tree, device):
    return _tree.tree_map(lambda x: x.to(device), tree)


def _start(cfg, traj, device):
    t0 = torch.zeros((), dtype=DT)
    return _to(E.init(cfg, traj.pose_fn(t0), traj.vel_fn(t0),
                      torch.zeros(6, dtype=DT), t0 - 1e-3), device)


def _road(cfg, n, device, reject=(1,), unhealthy=(2,)):
    """The road drive's initial engine state and its first ``n`` chunks."""
    traj = soak.soak_trajectory()
    g = torch.Generator().manual_seed(11)
    chunks = [_chunk(traj, k, g, device, k in reject, k in unhealthy)
              for k in range(n)]
    return _start(cfg, traj, device), chunks


def _lanes(cfg, lanes, chunks, device):
    """``lanes`` drives of ``chunks`` chunks each (lane l at 4 + l m/s, its
    own noise, the gate dropping sweep l % chunks in odd lanes) stacked on
    a lane axis, with each lane's IMU stream over the whole pass."""
    states, tls, imus = [], [], []
    for lane in range(lanes):
        traj = soak.soak_trajectory(4.0 + lane)
        g = torch.Generator().manual_seed(100 + lane)
        parts = [_chunk(traj, k, g, "cpu",
                        reject=lane % 2 == 1 and k == lane % chunks)
                 for k in range(chunks)]
        tls.append(E.Timeline(*(torch.cat(f) for f in
                                zip(*(tl for tl, _ in parts)))))
        imu_t = torch.arange(int((chunks * CHUNK + 0.35) * 200),
                             dtype=DT) / 200.0
        imu = syn.sample_imu(traj, imu_t, accel_noise=0.05, gyro_noise=5e-3,
                             generator=g)
        imus.append((imu.times, imu.accel, imu.gyro))
        states.append(_start(cfg, traj, "cpu"))

    def stack(trees):
        return _to(_tree.tree_map(lambda *x: torch.stack(x), *trees), device)

    return stack(states), stack(tls), stack(imus)


def _bits(x):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _assert_same_bits(a, b):
    la, lb = _tree.tree_leaves(a), _tree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert torch.equal(_bits(x), _bits(y))


def _eager(monkeypatch):
    monkeypatch.setattr(_cudagraph, "graph_device", lambda *trees: None)


def _counted(fn, *args):
    with TR.recording() as rec:
        out = fn(*args)
    return out, rec.trace.counts


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cpu", "vmap", "capturing", "grad",
                                  "no_grad", "plain"])
def test_the_graph_path_is_chosen_from_the_inputs(case, monkeypatch):
    """CPU tensors, a caller's ``vmap``, a capture under way and inputs
    that record autograd take the eager step; a plain call on a card's
    tensors replays (the device test needs a card, the rest do not)."""
    x = torch.ones(3)
    if case == "cpu":
        assert _cudagraph.graph_device(x, (x, [x])) is None
        return
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    if case == "vmap":
        seen = []
        plain = _cudagraph.plain_call
        torch.func.vmap(lambda y: seen.extend(
            [plain([y]), plain([x])]) or y)(torch.ones(2, 3))
        assert seen == [False, False]
        return
    if case in ("grad", "no_grad"):
        x.requires_grad_()
    with torch.set_grad_enabled(case != "no_grad"):
        assert _cudagraph.plain_call([x]) == (case in ("plain", "no_grad"))


@pytest.mark.parametrize("case", [
    "gravity_f32", "gravity_f64", "diag_cov", "imu_mask", "j_window",
    "anchor_valid", "solved"])
def test_hoisted_constants_equal_the_values_they_replace(case):
    spec = E.SensorSpec(covariance_linear=0.3, covariance_angular=0.07)
    new, old = {
        "gravity_f32": (pre.gravity_vec(pre.ImuParams(), DT, "cpu"),
                        torch.tensor([0.0, 0.0, -9.81], dtype=DT)),
        "gravity_f64": (pre.gravity_vec(pre.ImuParams(), torch.float64, "cpu"),
                        torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64)),
        "diag_cov": (E._diag_cov(spec, DT, "cpu"),
                     torch.diag(torch.tensor([0.3] * 3 + [0.07] * 3,
                                             dtype=DT))),
        "imu_mask": (_consts.const((1.0,) + (0.0,) * 4, DT, "cpu"),
                     torch.zeros(5, dtype=DT).index_fill_(0,
                                                          torch.tensor([0]),
                                                          1.0)),
        "j_window": (torch.full((), 5, dtype=torch.int32),
                     torch.tensor(5, dtype=torch.int32)),
        "anchor_valid": (torch.full((), 1.0 * float(True), dtype=DT),
                         torch.tensor(1.0 * float(True), dtype=DT)),
        "solved": (torch.full((), float(False), dtype=DT),
                   torch.tensor(float(False), dtype=DT)),
    }[case]
    _assert_same_bits(new, old)
    if case.startswith("gravity"):      # made once, then shared
        assert pre.gravity_vec(pre.ImuParams(), new.dtype, "cpu") is new


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("solve", [False, True])
def test_the_step_makes_no_host_sync_and_no_host_data_tensor(lanes, solve):
    """What a CUDA graph capture refuses: a read of a device value on the
    host (``.item()`` of a 0-d index, say) or a tensor built from host data
    (``torch.tensor`` of Python numbers), once the lazy constants exist."""
    cfg = _road_cfg()
    if lanes:
        es, tl, imu = _lanes(cfg, 2, 1, "cpu")
        ev = E.Timeline(*(x[:, 2] for x in tl))
    else:
        es, [(tl, imu)] = _road(cfg, 1, "cpu")
        ev = E.Timeline(*(x[2] for x in tl))
    fn = functools.partial(E._lane_step, cfg, E._source_tables(cfg, DT, "cpu"),
                           solve)
    if lanes:
        fn = torch.func.vmap(fn)
    fn(es, ev, *imu)
    with _Ops() as ops:
        fn(es, ev, *imu)
    bad = {"aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero",
           "aten.masked_select", "aten.item"}
    assert not bad & set(ops.names), ops.names


def _graphs_as_bodies(monkeypatch):
    """The graph path on the CPU: the inputs count as a card's, and each
    capture runs its row's step and gives back its body, run eagerly at
    every replay."""
    monkeypatch.setattr(_cudagraph, "graph_device",
                        lambda *trees: _tree.tree_leaves(trees)[0].device)

    def capture(self, fn):
        self._body(fn)
        return [(SimpleNamespace(replay=functools.partial(self._body, fn)),
                 None)]

    monkeypatch.setattr(_cudagraph.Graphs, "_capture", capture)


@pytest.mark.parametrize("lanes", [False, True])
def test_the_graph_path_equals_the_eager_step_on_the_cpu(lanes, monkeypatch):
    """Buffers, row copies, outputs and the carried state: ``run`` over
    three road chunks (a dropped sweep, a rejected event), ``run_lanes``
    over a 2-lane pass, both from the state the last call returned."""
    cfg = _road_cfg()
    if lanes:
        es0, tl, imu = _lanes(cfg, 2, 2, "cpu")
        calls = [(tl, imu), (tl, imu)]
        run = E.run_lanes
    else:
        es0, calls = _road(cfg, 3, "cpu")
        run = E.run
    eager, graph = [], []
    for side, got in (("eager", eager), ("graph", graph)):
        with monkeypatch.context() as m:
            (_graphs_as_bodies if side == "graph" else _eager)(m)
            es = es0
            for tl, imu in calls:
                (es, out), counts = _counted(run, cfg, es, tl, *imu)
                got.append((es, out, counts))
    for (es_e, out_e, c_e), (es_g, out_g, c_g), k in zip(eager, graph,
                                                         range(9)):
        _assert_same_bits(out_e, out_g)
        _assert_same_bits(es_e, es_g)
        steps = out_e.times.shape[-1]
        captures = 2 if k == 0 else 0
        assert c_e == {"engine.steps": steps}
        assert c_g == {"engine.steps": steps,
                       "engine.graph_replays": steps - captures,
                       **({"engine.graph_captures": 2} if k == 0 else {})}
    assert not bool(out_e.healthy.all()) or lanes   # the guard rejected one
    leaves = _tree.tree_leaves(_entries()[0].carry)
    held = {x.untyped_storage().data_ptr() for x in leaves}
    assert not held & {x.untyped_storage().data_ptr()
                       for x in _tree.tree_leaves(graph[-1][:2])}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU build")
    return torch.device("cuda", 0)


def _both(run, cfg, es, tl, imu, monkeypatch):
    """(graph side with its counters, eager side) of one call."""
    got, counts = _counted(run, cfg, es, tl, *imu)
    with monkeypatch.context() as m:
        _eager(m)
        ref = run(cfg, es, tl, *imu)
    return got, counts, ref


@pytest.mark.cuda
def test_run_replays_the_eager_step_over_road_chunks(dev, monkeypatch):
    cfg = _road_cfg()
    es, chunks = _road(cfg, 6, dev)
    rejected = 0
    for k, (tl, imu) in enumerate(chunks):
        (es_g, out_g), counts, (es_e, out_e) = _both(E.run, cfg, es, tl, imu,
                                                     monkeypatch)
        _assert_same_bits(out_g, out_e)
        _assert_same_bits(es_g, es_e)
        assert counts == {"engine.steps": 3,
                          "engine.graph_replays": 3 - 2 * (k == 0),
                          **({"engine.graph_captures": 2} if k == 0 else {})}
        rejected += int((out_g.healthy == 0).sum())
        es = es_g
    assert rejected >= 1


@pytest.mark.cuda
def test_run_lanes_replays_the_eager_step_over_a_town_pass(dev, monkeypatch):
    cfg = bench.bench_config().fusion
    es, tl, imu = _lanes(cfg, 8, 5, dev)       # 15 events a lane
    for k in range(2):
        (es_g, out_g), counts, (es_e, out_e) = _both(E.run_lanes, cfg, es,
                                                     tl, imu, monkeypatch)
        _assert_same_bits(out_g, out_e)
        _assert_same_bits(es_g, es_e)
        assert counts == {"engine.steps": 15,
                          "engine.graph_replays": 15 - 2 * (k == 0),
                          **({"engine.graph_captures": 2} if k == 0 else {})}


@pytest.mark.cuda
def test_run_from_a_restored_checkpoint(dev, monkeypatch, tmp_path):
    cfg = _road_cfg()
    es, chunks = _road(cfg, 4, dev)
    for tl, imu in chunks[:3]:
        es, _ = E.run(cfg, es, tl, *imu)
    CK.save(str(tmp_path / "engine.npz"), es)
    restored = CK.restore(str(tmp_path / "engine.npz"),
                          _road(cfg, 0, dev)[0])
    _assert_same_bits(restored, es)
    tl, imu = chunks[3]
    (es_g, out_g), counts, (es_e, out_e) = _both(E.run, cfg, restored, tl,
                                                 imu, monkeypatch)
    _assert_same_bits(out_g, out_e)
    _assert_same_bits(es_g, es_e)
    assert counts == {"engine.steps": 3, "engine.graph_replays": 3}


@pytest.mark.cuda
def test_two_windows_in_one_process_share_no_buffers(dev, monkeypatch):
    cfgs = [_road_cfg(6), _road_cfg(8)]
    runs = [_road(cfg, 3, dev) for cfg in cfgs]
    states = [es for es, _ in runs]
    for k in range(3):
        for i, cfg in enumerate(cfgs):
            tl, imu = runs[i][1][k]
            (es_g, out_g), counts, (es_e, out_e) = _both(
                E.run, cfg, states[i], tl, imu, monkeypatch)
            _assert_same_bits(out_g, out_e)
            _assert_same_bits(es_g, es_e)
            assert counts["engine.graph_replays"] == 3 - 2 * (k == 0)
            assert counts.get("engine.graph_captures", 0) == (
                2 if k == 0 else 0)
            states[i] = es_g
    assert len(_entries()) == 2
    a, b = ({x.untyped_storage().data_ptr()
             for x in _tree.tree_leaves((g.carry, g.row, g.extra, g.out))}
            for g in _entries())
    assert not a & b

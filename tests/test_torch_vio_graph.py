"""The VIO EKF's captured frame step: on a card,
``frontends/vio/pipeline.run`` and ``run_lanes`` replay the whole step as
one CUDA graph per key through ``_cudagraph.scan``.

On the CPU: when the graph path is taken; the step makes no host sync and
builds no tensor from host data (what a capture refuses); and the graph
path, through stand-ins for ``torch.cuda.CUDAGraph`` that record the ops
dispatched inside the capture and run them again at each replay, equals
the eager loop bit for bit over carried frames, a singular innovation's
NaN included, and counts one capture and a replay per later frame.

On the card (marked ``cuda``; skips without one), bit for bit against the
eager step in f32 with TF32 off, one capture per key: ``run`` over six
carried road chunks, ``run_lanes`` over an 8-lane town pass, a singular
innovation's NaN, and ``run_vil`` through ``run_scenario`` on a tunnel
drive. On a machine with an NVIDIA card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_vio_graph.py
"""

import collections
import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu_torch import _cudagraph, _tree
from vil_sensor_fusion_tpu_torch import bench, soak
from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.frontends.vio import ekf as E
from vil_sensor_fusion_tpu_torch.frontends.vio import pipeline as P
from vil_sensor_fusion_tpu_torch.frontends.vio import synthetic as VS
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

DT = torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    """Each test captures its own steps."""
    monkeypatch.setattr(_cudagraph, "_GRAPHS",
                        collections.defaultdict(collections.OrderedDict))


def _cpu_cfg(**kw):
    """The soak's VIO at a 160×120 camera and 8 slots."""
    return soak.soak_rig(160, 120, 8).vio._replace(**kw)


def _drive(cfg, n, speed=4.0, seed=0, device="cpu"):
    """The initial state and ``n`` frames of synthetic tracks along the
    soak's road weave (every slot re-initialised at frame 0, others as
    their landmarks leave the view), in f32 on ``device``."""
    traj = soak.soak_trajectory(speed)
    times = (np.arange(n) + 1.0) / 20.0
    poses = torch.func.vmap(traj.pose_fn)(
        torch.as_tensor(times, dtype=torch.float64)).numpy()
    imu = VS.imu_windows_for_frames(traj, times, imu_hz=200.0,
                                    device="cpu")
    lms = VS.landmark_field(400, seed=seed + 1, extent=40.0,
                            height=(0.5, 10.0))
    lms[:, 0] = np.random.default_rng(seed + 3).uniform(-10.0, 60.0, 400)
    frames = VS.make_frames(cfg, poses, imu, lms, seed=seed)
    t0 = torch.zeros((), dtype=torch.float64)
    s0 = E.init(cfg, traj.pose_fn(t0), traj.vel_fn(t0),
                torch.zeros(6, dtype=torch.float64))
    return _tree.tree_map(lambda x: x.to(device, DT), (s0, frames))


def _singular(cfg, n, device="cpu"):
    """A state whose attitude and accelerometer-bias rows are exactly known
    and a filter with no gyro, bias or gravity noise, at rest under
    gravity: the gyro turns for the first two frames, then stops, and the
    gravity row's innovation is the zero matrix (NaN from frame 2 on)."""
    cfg = cfg._replace(gravity_sigma=0.0, cov_gyro=0.0, cov_bias_acc=0.0,
                       cov_bias_omega=0.0)
    pose0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 1.5], dtype=DT, device=device)
    s = E.init(cfg, pose0, torch.tensor([0.02, 0.0, 0.0], dtype=DT,
                                        device=device),
               torch.zeros(6, dtype=DT, device=device))
    keep = torch.ones(s.cov.shape[0], dtype=DT, device=device)
    keep[0:3] = 0.0
    keep[9:15] = 0.0
    s = s._replace(cov=s.cov * keep[:, None] * keep[None, :])
    M, N = cfg.num_landmarks, 11
    gyro = torch.zeros(n, N, 3, dtype=DT, device=device)
    gyro[:2, :, 2] = 0.1
    frames = P.VioFrameInput(
        accel=torch.tensor([0.0, 0.0, 9.81], dtype=DT,
                           device=device).expand(n, N, 3).clone(),
        gyro=gyro, dts=torch.full((n, N), 0.005, dtype=DT, device=device),
        obs_uv=torch.zeros(n, M, 2, dtype=DT, device=device),
        obs_valid=torch.zeros(n, M, dtype=DT, device=device),
        obs_depth=torch.zeros(n, M, dtype=DT, device=device),
        new_uv=torch.full((n, M, 2), 50.0, dtype=DT, device=device),
        new_depth=torch.full((n, M), 8.0, dtype=DT, device=device),
        new_enable=(torch.arange(n, device=device)[:, None] == 1).to(
            DT).expand(n, M).clone())
    return cfg, s, frames


def _reinit(frames, t, slots=(1, 3)):
    """``frames`` with ``slots`` re-initialised at frame ``t`` (the last
    axis but the slot's) from their tracked pixel and depth."""
    enable = frames.new_enable.clone()
    enable[..., t, list(slots)] = 1.0
    on = enable > 0
    return frames._replace(
        new_enable=enable,
        new_uv=torch.where(on[..., None] & (frames.obs_valid[..., None] > 0),
                           frames.obs_uv, frames.new_uv),
        new_depth=torch.where(on & (frames.obs_depth > 0), frames.obs_depth,
                              frames.new_depth))


def _lanes(cfg, lanes, n, device="cpu"):
    """``lanes`` distinct drives (speed and landmarks per lane), stacked
    along a leading lane axis."""
    drives = [_drive(cfg, n, 3.0 + 0.5 * b, seed=b, device=device)
              for b in range(lanes)]
    return _tree.tree_map(lambda *x: torch.stack(x), *drives)


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

class _Eager(Exception):
    pass


class _Graph(Exception):
    pass


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("case", ["cpu", "vmap", "grad", "capturing",
                                  "plain"])
def test_the_graph_path_is_chosen_from_the_inputs(case, lanes, monkeypatch):
    """CPU tensors, a caller's ``vmap``, inputs that record autograd and a
    capture under way take the eager step, reached through the module's
    ``step``; a plain call on a card's tensors replays. The card is stood
    in for by the decision's device test alone."""

    def step(*a, **kw):
        raise _Eager

    def graphs(*a, **kw):
        raise _Graph

    monkeypatch.setattr(P, "step", step)
    monkeypatch.setattr(_cudagraph, "Graphs", graphs)
    if case != "cpu":
        monkeypatch.setattr(_cudagraph, "graph_device", lambda *trees: (
            torch.device("cpu") if _cudagraph.plain_call(
                _tree.tree_leaves(trees)) else None))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    cfg = _cpu_cfg()
    s, frames = _drive(cfg, 2)
    if case == "grad":
        s = s._replace(vel=s.vel.clone().requires_grad_())
    args = (s, frames)
    if lanes:
        args = _tree.tree_map(lambda x: x[None], args)
    run = P.run_lanes if lanes else P.run
    if case == "vmap":
        args = _tree.tree_map(lambda x: x[None], args)
        fn = torch.func.vmap(functools.partial(run, cfg))
    else:
        fn = functools.partial(run, cfg)
    with pytest.raises(_Graph if case == "plain" else _Eager):
        fn(*args)


class _Ops(TorchDispatchMode):
    """The ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("pseudo, depth", [(True, True), (False, False)])
def test_the_step_makes_no_host_sync_and_no_host_data_tensor(pseudo, depth,
                                                             lanes):
    """What a CUDA graph capture refuses: a read of a device value on the
    host or a tensor built from host data (``torch.tensor`` of Python
    numbers, ``torch.as_tensor`` of a numpy array, a Python number
    assigned through an index), once the lazy constants exist: a second
    frame, with and without the gravity, zero-velocity and depth rows,
    alone and over two lanes."""
    cfg = _cpu_cfg(use_gravity_update=pseudo,
                   use_zero_velocity_update=pseudo, use_depth_update=depth)
    s, frames = _lanes(cfg, 2, 2) if lanes else _drive(cfg, 2)
    axis = 1 if lanes else 0
    one = functools.partial(P.step, cfg)
    fn = torch.func.vmap(one) if lanes else one
    row = [_tree.tree_map(lambda x: x.select(axis, t), frames)
           for t in range(2)]
    s, _ = fn(s, row[0])
    ops = _Ops()
    with ops:
        fn(s, row[1])
    bad = {"aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero",
           "aten.masked_select", "aten.item", "aten._assert_async"}
    assert not bad & set(ops.names), ops.names
    assert ops.names["aten._linalg_solve_ex"] > 0


class _Record(TorchDispatchMode):
    """Appends every op dispatched to ``ops``: an op that writes into its
    arguments is held back (a capture runs nothing), any other runs, so
    that the code around it sees tensors of the right shapes."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._schema.is_mutable:
            self.ops.append((func, args, kwargs, None))
            return args[0] if func._schema.returns else None
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _RecordingGraph:
    """A CUDA graph stand-in: records between ``capture_begin`` and
    ``capture_end``; ``replay`` runs the ops again, each one's result
    copied into the tensor it gave at capture (but a ``jacfwd`` zero
    tangent, which holds no storage and stays zero)."""

    made = 0

    def __init__(self):
        self.ops, self.mode = [], None
        _RecordingGraph.made += 1

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.mode = _Record(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            if out is not None:
                for o, r in zip(_tree.tree_leaves(out),
                                _tree.tree_leaves(res)):
                    if not o._is_zerotensor():
                        o.copy_(r)


def _recording_graphs(monkeypatch):
    """The graph path on the CPU: the inputs count as a card's, and the
    real capture records into :class:`_RecordingGraph`."""

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(_cudagraph, "graph_device",
                        lambda *trees: _tree.tree_leaves(trees)[0].device)
    monkeypatch.setattr(_cudagraph, "capture_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordingGraph)
    _RecordingGraph.made = 0


def _sides(run, cfg, state0, calls, monkeypatch):
    """The eager and the graph side of ``calls``, each call from the state
    that side's last call returned: a list of (state, outputs, counters)
    per side."""
    got = {}
    for side in ("eager", "graph"):
        with monkeypatch.context() as m:
            (_recording_graphs if side == "graph" else _eager)(m)
            state, got[side] = state0, []
            for frames in calls:
                (state, out), counts = _counted(run, cfg, state, frames)
                got[side].append((state, out, counts))
    return got["eager"], got["graph"]


def _check_sides(eager, graph):
    for k, ((st_e, out_e, c_e), (st_g, out_g, c_g)) in enumerate(
            zip(eager, graph)):
        _assert_same_bits(out_e, out_g)
        _assert_same_bits(st_e, st_g)
        T = out_e.pose.shape[-2]
        assert c_e["vio.frames"] == c_g["vio.frames"] == T
        assert c_g.get("vio.graph_replays", 0) == T - (k == 0)
        assert c_g.get("vio.graph_captures", 0) == (k == 0)
        assert "vio.graph_replays" not in c_e


@pytest.mark.parametrize("lanes", [False, True])
def test_the_graph_path_equals_the_eager_step_on_the_cpu(lanes, monkeypatch):
    """Through the real capture into recording graphs: ``run`` over two
    calls of three and two frames (slots re-initialised in the replayed
    frames), ``run_lanes`` over two lanes, each call from the state the
    last one returned; one graph, nothing returned aliasing a buffer."""
    cfg = _cpu_cfg()
    state0, frames = _lanes(cfg, 2, 5) if lanes else _drive(cfg, 5)
    frames = _reinit(_reinit(frames, 2), 4, (0, 5))
    axis = 1 if lanes else 0
    calls = [_tree.tree_map(lambda x: x.narrow(axis, a, b - a), frames)
             for a, b in ((0, 3), (3, 5))]
    eager, graph = _sides(P.run_lanes if lanes else P.run, cfg, state0,
                          calls, monkeypatch)
    _check_sides(eager, graph)
    assert _RecordingGraph.made == 1
    [entry] = _cudagraph._GRAPHS["vio"].values()
    held = {x.untyped_storage().data_ptr()
            for x in _tree.tree_leaves((entry.carry, entry.out))}
    assert not held & {x.untyped_storage().data_ptr()
                       for x in _tree.tree_leaves(graph[-1][:2])}


def test_a_singular_innovation_replays_as_the_eager_nan(monkeypatch):
    """The gravity row's zero innovation matrix at frame 2, a replayed
    frame: NaN from there on, bit for bit as the eager step gives it."""
    cfg, state0, frames = _singular(_cpu_cfg(), 4)
    eager, graph = _sides(P.run, cfg, state0, [frames], monkeypatch)
    _check_sides(eager, graph)
    pose = graph[0][1].pose
    assert torch.isfinite(pose[:2]).all() and torch.isnan(pose[2:]).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU build")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda", 0)


def _both(fn, monkeypatch, *args):
    """(graph side, its counters, eager side) of one call."""
    got, counts = _counted(fn, *args)
    with monkeypatch.context() as m:
        _eager(m)
        ref, _ = _counted(fn, *args)
    return got, counts, ref


def _check_calls(fn, cfg, state, calls, monkeypatch):
    """Each call from the graph side's last state: graph against eager bit
    for bit, one capture in the first call and replays after it."""
    for k, frames in enumerate(calls):
        (st_g, out_g), counts, (st_e, out_e) = _both(fn, monkeypatch, cfg,
                                                     state, frames)
        _assert_same_bits(out_g, out_e)
        _assert_same_bits(st_g, st_e)
        T = frames.accel.shape[-3]
        assert counts["vio.frames"] == T
        assert counts.get("vio.graph_captures", 0) == (k == 0)
        assert counts.get("vio.graph_replays", 0) == T - (k == 0)
        state = st_g
    return state


@pytest.mark.cuda
def test_run_replays_the_eager_step_over_road_chunks(dev, monkeypatch):
    """Six 0.1 s chunks of the road-soak stream's VIO (24 slots, 800×600),
    two frames each, the state carried; slots re-initialised in replayed
    frames."""
    cfg = soak.soak_rig(800, 600, 24).vio
    state, frames = _drive(cfg, 12, device=dev)
    frames = _reinit(_reinit(frames, 3), 8, (0, 5, 23))
    calls = [_tree.tree_map(lambda x: x[a:a + 2], frames)
             for a in range(0, 12, 2)]
    state = _check_calls(P.run, cfg, state, calls, monkeypatch)
    assert torch.isfinite(state.cov).all()


@pytest.mark.cuda
def test_run_lanes_replays_the_eager_step_over_a_town_pass(dev, monkeypatch):
    """The bench's VIO stage over 8 distinct drives of 10 frames, two
    passes from the same states: each frame of all lanes one replay."""
    cfg = bench.bench_config().vio
    state, frames = _lanes(cfg, 8, 10, device=dev)
    frames = _reinit(frames, 4)
    for k in range(2):
        (st_g, out_g), counts, (st_e, out_e) = _both(
            P.run_lanes, monkeypatch, cfg, state, frames)
        _assert_same_bits(out_g, out_e)
        _assert_same_bits(st_g, st_e)
        assert counts["vio.frames"] == 10
        assert counts.get("vio.graph_captures", 0) == (k == 0)
        assert counts["vio.graph_replays"] == 10 - (k == 0)


@pytest.mark.cuda
def test_a_singular_innovation_replays_as_the_eager_nan_on_the_card(
        dev, monkeypatch):
    """The CPU case's singular gravity row at the stream's 24 slots, alone
    and over 8 lanes: NaN from the replayed frame 2 on, bit for bit."""
    cfg, state, frames = _singular(soak.soak_rig(800, 600, 24).vio, 4, dev)
    (st, out), counts, ref = _both(P.run, monkeypatch, cfg, state, frames)
    _assert_same_bits((st, out), ref)
    assert counts["vio.graph_captures"] == 1
    assert torch.isfinite(out.pose[:2]).all()
    assert torch.isnan(out.pose[2:]).all()
    lanes = _tree.tree_map(lambda x: torch.stack([x] * 8), (state, frames))
    got, counts, ref = _both(P.run_lanes, monkeypatch, cfg, *lanes)
    _assert_same_bits(got, ref)
    assert counts["vio.graph_replays"] == 3


def _same_result(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            _same_result(x, y)
        elif isinstance(x, np.ndarray) and x.dtype.kind == "f":
            assert x.shape == y.shape and np.array_equal(
                x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")), key
        else:
            assert np.array_equal(x, y) if isinstance(x, np.ndarray) \
                else x == y, key


@pytest.mark.cuda
def test_run_vil_replays_the_eager_step_on_a_tunnel_drive(dev, monkeypatch):
    """``run_scenario`` on the 1.2 s tunnel drive at the experiment grid's
    settings (24 frames through ``run_vil``'s ``pipeline.run``), two
    passes: every output and score bit for bit."""
    spec = EX.ExperimentSpec("tunnel", 1.2, 0)
    cfg = EX.experiment_config(spec)
    sc = EX.experiment_scenario(spec, cfg, dev)
    for k in range(2):
        got, counts, ref = _both(EX.run_scenario, monkeypatch, spec, cfg, sc)
        _same_result(got, ref)
        frames = counts["vio.frames"]
        assert frames == 24
        assert counts.get("vio.graph_captures", 0) == (k == 0)
        assert counts["vio.graph_replays"] == frames - (k == 0)

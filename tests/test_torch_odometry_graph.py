"""The LiDAR odometry's captured sweep steps: on a card,
``frontends/lidar/odometry.run`` and ``run_lanes`` replay the step as a
chain of CUDA graphs split at each k-NN search, the searches launched
between the graphs.

On the CPU: when the graph path is taken; the perturbation shifts hoisted
into device constants equal ``linspace0``'s values; the step makes no host
sync and builds no tensor from host data (what a capture refuses); and the
graph path, with the capture's chain run as the body it captures, equals
the eager step bit for bit and counts one replay per later sweep.

On the card (marked ``cuda``; skips without one), bit for bit against the
eager step, with the kernel's launches counted as in the eager step and
one capture per key: ``run`` over six carried road-soak chunks,
``run_lanes`` over an 8-lane town-bench pass, ``run_vil`` through
``run_scenario`` on a tunnel drive with ``emit_dists``, and ``run`` with
maps that evict, hashed and exact. On a machine with an NVIDIA card and no
JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_odometry_graph.py
"""

import collections
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu_torch import _cudagraph, _linspace, _tree
from vil_sensor_fusion_tpu_torch import bench, soak
from vil_sensor_fusion_tpu_torch.core import lie
from vil_sensor_fusion_tpu_torch.data import raycast as rc
from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.frontends import lidar as L
from vil_sensor_fusion_tpu_torch.frontends.lidar import icp as I
from vil_sensor_fusion_tpu_torch.frontends.lidar import odometry as O
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as vm
from vil_sensor_fusion_tpu_torch.ops import knn as K
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

DT = torch.float32
STRIDE = 10                # CPU sweeps: every 10th azimuth column (16 × 180)


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    """Each test captures its own steps."""
    monkeypatch.setattr(_cudagraph, "_GRAPHS",
                        collections.defaultdict(collections.OrderedDict))


def _cfg(azimuth=rc.AZIMUTH // STRIDE, **kw):
    """The soak's LiDAR stage (two-stage, delta priors) at narrow maps."""
    return soak.soak_rig(160, 120, 8).lidar._replace(
        azimuth=azimuth,
        corner_map=vm.VoxelMapConfig(capacity=1024, leaf=0.2),
        surf_map=vm.VoxelMapConfig(capacity=2048, leaf=0.4),
        submap_corners=256, submap_surfs=512, **kw)


def _poses(n, lane=0, device="cpu", dx=0.4):
    """``n`` sensor poses 1.5 m up, moving along x with a slow turn."""
    x = torch.arange(n, dtype=torch.float64) * dx + 2.0 * lane
    yaw = 0.02 * x
    q = lie.so3_exp_quat(torch.stack([0 * yaw, 0 * yaw, yaw], -1))
    t = torch.stack([x, 0.05 * x, 1.5 + 0 * x], -1)
    return lie.pose_make(q, t).to(DT).to(device)


def _drive(world, poses, stride=1):
    """Sweeps at ``poses`` (every ``stride``-th column) and the delta
    guesses a drive from ``poses[0]`` gets, each nudged off the truth."""
    sw = rc.sweep_series(world, poses)
    sweeps = L.Sweep(*(x[:, :, ::stride].contiguous() for x in sw))
    prev = torch.cat([poses[:1], poses[:-1]])
    nudge = torch.zeros(poses.shape[0], 6, dtype=DT, device=poses.device)
    nudge[:, 0] = 0.05
    nudge[:, 5] = 0.004
    guesses = lie.pose_retract(lie.pose_between(prev, poses), nudge)
    return sweeps, guesses


@functools.cache
def _cpu_drive(n=3):
    world = rc.town_world(n_boxes=24, seed=2, dtype=DT, device="cpu")
    poses = _poses(n)
    return poses, *_drive(world, poses, STRIDE)


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
    """(fn's output, the counters it left, the kernel launches it made)."""
    launches = K.KERNEL_LAUNCHES
    with TR.recording() as rec:
        out = fn(*args)
    return out, rec.trace.counts, K.KERNEL_LAUNCHES - launches


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

class _Eager(Exception):
    pass


class _Graph(Exception):
    pass


@pytest.mark.parametrize("case, lanes", [
    (case, lanes) for lanes in (False, True)
    for case in ("cpu", "register_fn", "vmap", "grad", "capturing", "plain")
    if not (lanes and case == "register_fn")])
def test_the_graph_path_is_chosen_from_the_inputs(case, lanes, monkeypatch):
    """CPU tensors, a ``register_fn`` (the sharded registration), a
    caller's ``vmap``, inputs that record autograd and a capture under way
    take the eager step; a plain call on a card's tensors replays. The
    card is stood in for by the decision's device test alone
    (``run_lanes`` takes no ``register_fn``)."""

    def step(*a, **kw):
        raise _Eager

    def graphs(*a, **kw):
        raise _Graph

    monkeypatch.setattr(O, "step", step)
    monkeypatch.setattr(_cudagraph, "Graphs", graphs)
    if case != "cpu":
        monkeypatch.setattr(_cudagraph, "graph_device", lambda *trees: (
            torch.device("cpu") if _cudagraph.plain_call(
                _tree.tree_leaves(trees)) else None))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    cfg = _cfg()
    state = O.init(cfg, DT, device="cpu")
    _, sweeps, guesses = _cpu_drive()
    if case == "grad":
        guesses = guesses.clone().requires_grad_()
    args = (state, sweeps, guesses)
    if lanes:
        args = _tree.tree_map(lambda x: x[None], args)
    if case == "vmap":
        args = _tree.tree_map(lambda x: x[None], args)
        fn = torch.func.vmap(functools.partial(
            O.run_lanes if lanes else O.run, cfg))
    elif lanes:
        fn = functools.partial(O.run_lanes, cfg)
    elif case == "register_fn":
        fn = functools.partial(O.run, cfg,
                               register_fn=lambda *a: I.register(*a, cfg.icp))
    else:
        fn = functools.partial(O.run, cfg)
    with pytest.raises(_Graph if case == "plain" else _Eager):
        fn(*args)


@pytest.mark.parametrize("stop, num, dtype", [
    (0.2, 15, torch.float32), (0.2, 15, torch.float64),
    (0.2, 7, torch.float32), (1.0, 1, torch.float32)])
def test_hoisted_shifts_equal_linspace0_bit_for_bit(stop, num, dtype):
    new = _linspace.linspace0_const(stop, num, dtype, "cpu")
    _assert_same_bits(new, _linspace.linspace0(stop, num, dtype, "cpu"))
    assert _linspace.linspace0_const(stop, num, dtype, "cpu") is new


class _Ops(TorchDispatchMode):
    """The ops dispatched while it is on and not paused."""

    def __init__(self):
        super().__init__()
        self.names = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.names[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("emit_dists", [False, True])
@pytest.mark.parametrize("two_stage", [False, True])
def test_the_step_makes_no_host_sync_and_no_host_data_tensor(two_stage,
                                                             emit_dists,
                                                             monkeypatch):
    """What a CUDA graph capture refuses: a read of a device value on the
    host or a tensor built from host data (``torch.tensor`` of Python
    numbers, ``torch.as_tensor`` of a numpy array, a Python number
    assigned through an index), once the lazy constants exist. The k-NN
    searches are left out: on a card each is launched between two graphs.
    A second sweep, so that the map is not empty."""
    cfg = _cfg(two_stage=two_stage, emit_dists=emit_dists)
    poses, sweeps, guesses = _cpu_drive()
    state = O.init(cfg, DT, pose0=poses[0])
    state, _ = O.step(cfg, state, L.Sweep(*(x[0] for x in sweeps)),
                      guesses[0], compute_cov=False)
    ops = _Ops()

    def knn(*args):
        ops.paused = True
        try:
            return K.knn_torch(*args)
        finally:
            ops.paused = False

    monkeypatch.setattr(K, "knn", knn)
    with ops:
        O.step(cfg, state, L.Sweep(*(x[1] for x in sweeps)), guesses[1],
               compute_cov=False)
    bad = {"aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero",
           "aten.masked_select", "aten.item"}
    assert not bad & set(ops.names), ops.names


def _graphs_as_bodies(monkeypatch):
    """The graph path on the CPU: the inputs count as a card's, and a
    capture runs its row's step and makes one graph whose replay runs the
    body it captures."""
    monkeypatch.setattr(_cudagraph, "graph_device",
                        lambda *trees: _tree.tree_leaves(trees)[0].device)

    def capture(self, fn):
        self._body(fn)
        return [(SimpleNamespace(replay=functools.partial(self._body, fn)),
                 None)]

    monkeypatch.setattr(_cudagraph.Graphs, "_capture", capture)


@pytest.mark.parametrize("lanes", [False, True])
def test_the_graph_path_equals_the_eager_step_on_the_cpu(lanes, monkeypatch):
    """Buffers, row copies, stacked outputs, the covariance and the carried
    state: ``run`` over two calls of two and one sweeps, ``run_lanes`` over
    two lanes, each call from the state the last one returned."""
    cfg = _cfg(emit_dists=True)
    poses, sweeps, guesses = _cpu_drive()
    state0 = O.init(cfg, DT, pose0=poses[0])
    parts = [(L.Sweep(*(x[a:b] for x in sweeps)), guesses[a:b])
             for a, b in ((0, 2), (2, 3))]
    run = O.run
    if lanes:
        def two(x):
            return torch.stack([x, x.flip(0) if x.dim() > 2 else x])
        state0 = _tree.tree_map(lambda x: torch.stack([x, x]), state0)
        parts = [_tree.tree_map(two, p) for p in parts]
        run = O.run_lanes
    eager, graph = [], []
    for side, got in (("eager", eager), ("graph", graph)):
        with monkeypatch.context() as m:
            (_graphs_as_bodies if side == "graph" else _eager)(m)
            state = state0
            for sw, g in parts:
                (state, out), counts, _ = _counted(run, cfg, state, sw, g)
                got.append((state, out, counts))
    for k, ((st_e, out_e, c_e), (st_g, out_g, c_g)) in enumerate(
            zip(eager, graph)):
        _assert_same_bits(out_e, out_g)
        _assert_same_bits(st_e, st_g)
        T = out_e.pose.shape[-2]
        assert c_e["odometry.sweeps"] == T
        assert c_g["odometry.sweeps"] == T
        assert c_g.get("odometry.graph_replays", 0) == T - (k == 0)
        assert c_g.get("odometry.graph_captures", 0) == (k == 0)
        assert "odometry.graph_replays" not in c_e
    leaves = _tree.tree_leaves(
        next(iter(_cudagraph._GRAPHS["odometry"].values())).carry)
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


def _both(fn, monkeypatch, *args):
    """(graph side, its counters, its launches, eager side, its launches)
    of one call."""
    got, counts, launches = _counted(fn, *args)
    with monkeypatch.context() as m:
        _eager(m)
        ref, _, ref_launches = _counted(fn, *args)
    return got, counts, launches, ref, ref_launches


def _check_calls(fn, cfg, state, calls, monkeypatch):
    """Each call from the graph side's last state: graph against eager bit
    for bit, the same launches, one capture in the first call and replays
    after it."""
    for k, (sweeps, guesses) in enumerate(calls):
        (st_g, out_g), counts, n_g, (st_e, out_e), n_e = _both(
            fn, monkeypatch, cfg, state, sweeps, guesses)
        _assert_same_bits(out_g, out_e)
        _assert_same_bits(st_g, st_e)
        assert n_g == n_e > 0
        T = guesses.shape[-2]
        assert counts.get("odometry.graph_captures", 0) == (k == 0)
        assert counts.get("odometry.graph_replays", 0) == T - (k == 0)
        state = st_g
    return state


@pytest.mark.cuda
def test_run_replays_the_eager_step_over_road_chunks(dev, monkeypatch):
    """Six 0.1 s chunks of the soak's road drive, one sweep each, the
    state carried (14 k-NN searches a sweep)."""
    cfg = soak.soak_rig(160, 120, 8).lidar
    traj = soak.soak_trajectory()
    world = rc.road_world(seed=3, dtype=DT, device=dev)
    t = torch.arange(7, dtype=DT, device=dev) * 0.1
    poses = torch.func.vmap(traj.pose_fn)(t)
    sweeps, guesses = _drive(world, poses)
    state = O.init(cfg, DT, pose0=poses[0])
    calls = [(L.Sweep(*(x[k:k + 1] for x in sweeps)), guesses[k:k + 1])
             for k in range(1, 7)]
    _check_calls(O.run, cfg, state, calls, monkeypatch)


@pytest.mark.cuda
def test_run_lanes_replays_the_eager_step_over_a_town_pass(dev, monkeypatch):
    """The bench's LiDAR stage over 8 distinct town drives of 5 sweeps, two
    passes from the same states (4 searches a sweep, all lanes in one
    launch each)."""
    cfg = bench.bench_config().lidar
    lanes = []
    for lane in range(8):
        world = rc.town_world(n_boxes=24, seed=lane, dtype=DT, device=dev)
        poses = _poses(5, lane, dev)
        lanes.append((O.init(cfg, DT, pose0=poses[0]),
                      *_drive(world, poses)))
    state, sweeps, guesses = (_tree.tree_map(lambda *x: torch.stack(x), *f)
                              for f in zip(*lanes))
    for k in range(2):
        (st_g, out_g), counts, n_g, (st_e, out_e), n_e = _both(
            O.run_lanes, monkeypatch, cfg, state, sweeps, guesses)
        _assert_same_bits(out_g, out_e)
        _assert_same_bits(st_g, st_e)
        assert n_g == n_e == 5 * 4
        assert counts.get("odometry.graph_captures", 0) == (k == 0)
        assert counts["odometry.graph_replays"] == 5 - (k == 0)


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
    """``run_scenario`` on a 1.2 s tunnel drive at the experiment grid's
    settings: ``emit_dists``' perturbation sweep, 34 searches a sweep, the
    scores, two passes."""
    spec = EX.ExperimentSpec("tunnel", 1.2, 0)
    cfg = EX.experiment_config(spec)
    sc = EX.experiment_scenario(spec, cfg, dev)
    for k in range(2):
        got, counts, n_g, ref, n_e = _both(EX.run_scenario, monkeypatch,
                                           spec, cfg, sc)
        _same_result(got, ref)
        sweeps = len(got["lidar_times"])
        assert n_g == n_e == 34 * sweeps
        assert counts.get("odometry.graph_captures", 0) == (k == 0)
        assert counts["odometry.graph_replays"] == sweeps - (k == 0)


@pytest.mark.parametrize("hashed", [True, False])
@pytest.mark.cuda
def test_run_replays_the_eager_step_with_evicting_maps(dev, hashed,
                                                       monkeypatch):
    """Narrow maps whose points beyond 25 m are evicted every sweep, the
    hashed insert and the exact one, over a fast field drive in two calls
    of four sweeps."""
    maps = dict(keep_radius=25.0, hashed=hashed)
    cfg = soak.soak_rig(160, 120, 8).lidar._replace(
        corner_map=vm.VoxelMapConfig(capacity=4096, leaf=0.2, **maps),
        surf_map=vm.VoxelMapConfig(capacity=8192, leaf=0.4, **maps),
        submap_corners=1024, submap_surfs=2048)
    world = rc.field_world(40.0, 80.0, 120.0, seed=1, dtype=DT, device=dev)
    poses = _poses(9, 0, dev, dx=1.6)
    sweeps, guesses = _drive(world, poses)
    state = O.init(cfg, DT, pose0=poses[0])
    calls = [(L.Sweep(*(x[a:a + 4] for x in sweeps)), guesses[a:a + 4])
             for a in (1, 5)]
    state = _check_calls(O.run, cfg, state, calls, monkeypatch)
    assert float(state.surf_map.mask.sum()) > 0

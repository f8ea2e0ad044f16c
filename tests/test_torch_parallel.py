"""The port's lane-batched engine and ``parallel``'s data axis against the
JAX package, in float64 on identical inputs.

- Lanes: ``fusion.engine.run_lanes`` on 4 lanes of the tiny fusion problem
  that differ in keep mask, odometry and source, against
  ``jax.vmap(E.run)`` and against the port's single-lane ``run`` of each
  lane (atol 1e-9); its aten ops per event do not grow with the lane count,
  and no ``vmap`` batching rule falls back to a per-lane loop.
- Ranks: two gloo processes (``torch.multiprocessing.spawn``, a
  ``file://`` store under ``tmp_path``) run ``batched_fusion_run``,
  ``make_vil_step`` and ``sharded_metric_series``, held against JAX's
  ``vmap`` of the unsharded functions and the port's one-process lanes.
  The model axis is ``test_torch_model_axis.py``'s.
"""

import importlib
import pickle
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.frontends.lidar import icp as JI
from vil_sensor_fusion_tpu_torch import _tree, convert
from vil_sensor_fusion_tpu_torch import fusion as TFU
from vil_sensor_fusion_tpu_torch import parallel as TPAR
from vil_sensor_fusion_tpu_torch.parallel import multihost as MH
from vil_sensor_fusion_tpu_torch.parallel.step import make_vil_step

DT = jnp.float64
B = 4                    # lanes
RANKS = 2
FALLBACK = ".*performance drop.*batching rule.*"
METRIC_NAMES = ("d_opt", "e_opt", "condition_number")


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _np(x):
    return np.asarray(x)


def _close(a, b, atol=1e-9, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def _tree_close(tt, tj, **kw):
    for name in tj._fields:
        a, b = getattr(tt, name), getattr(tj, name)
        if isinstance(b, tuple):
            _tree_close(a, b, **kw)
        else:
            _close(a.numpy(), b, msg=name, **kw)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, init, fn, args):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks (a ``file://``
    store under ``tmp_path``, no port)."""
    init = f"file://{tmp_path / f'store-{fn.__name__}'}"
    torch.multiprocessing.spawn(_rank_entry, args=(world, init, fn, args),
                                nprocs=world, join=True)


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The lane problem
# ---------------------------------------------------------------------------

def _to_jax(tree):
    """Port tree → the JAX package's tree of the same types (numpy values
    as JAX arrays), so both sides start from identical inputs."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        mod = type(tree).__module__.replace("vil_sensor_fusion_tpu_torch",
                                            "vil_sensor_fusion_tpu")
        cls = getattr(importlib.import_module(mod), type(tree).__name__)
        return cls(**{f: _to_jax(getattr(tree, f)) for f in tree._fields
                      if f in cls._fields})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    return tree


def _tiny_problem(n_events=9, n_imu=96):
    """The tiny fusion problem (circle drive, 2 sensors, f64) from the
    port's copy of ``__graft_entry__._tiny_problem``, as JAX values: config,
    initial engine state, timeline, IMU (times, accel, gyro)."""
    cfg, (es, tl, it, ia, ig) = MH._tiny_problem(
        torch.float64, n_events=n_events, n_imu=n_imu, device="cpu")
    return _to_jax((cfg, es, tl, (it, ia, ig)))


def _lane_problem():
    """B lanes of the tiny problem: lane 0 as is; lane 1 drops a VIO and a
    LiDAR event (keep 0); lane 2's odometry poses perturbed; lane 3 with
    the source of two events swapped (a LiDAR event that solves, a VIO one
    that does not). Returns (cfg, batched JAX inputs)."""
    cfg, es, tl, imu = _tiny_problem()
    rng = np.random.default_rng(6)
    src = np.asarray(tl.source)
    vio_ev, lid_ev = np.nonzero(src == 0)[0], np.nonzero(src == 1)[0]
    keep = np.stack([np.asarray(tl.keep)] * B)
    keep[1, [vio_ev[2], lid_ev[1]]] = 0.0
    odo = np.stack([np.asarray(tl.odo_pose)] * B)
    xi = jnp.asarray(rng.normal(0.0, 0.02, (odo.shape[1], 6)))
    odo[2] = np.asarray(JL.pose_retract(jnp.asarray(odo[2]), xi))
    source = np.stack([src] * B)
    source[3, lid_ev[0]], source[3, vio_ev[3]] = 0, 1
    stack = lambda x: jnp.broadcast_to(x[None], (B,) + x.shape)
    tlb = jax.tree_util.tree_map(stack, tl)._replace(
        keep=jnp.asarray(keep), odo_pose=jnp.asarray(odo),
        source=jnp.asarray(source))
    esb, itb, iab, igb = jax.tree_util.tree_map(stack, (es, *imu))
    return cfg, (esb, tlb, itb, iab, igb)


@pytest.fixture(scope="module")
def lanes():
    cfg, args = _lane_problem()
    es_j, out_j = jax.jit(jax.vmap(
        lambda s, tl, t, a, g: JFU.run(cfg, s, tl, t, a, g)))(*args)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        es_t, out_t = TFU.run_lanes(_t(cfg), *_t(args))
    return dict(cfg=cfg, args=args, jax=(es_j, out_j), port=(es_t, out_t))


def test_lanes_differ_in_what_they_should(lanes):
    """The lane problem exercises per-lane drops, sources and odometry: the
    dropped and the swapped lanes solve at other events than lane 0, and
    the perturbed lane's fused poses move."""
    solved = np.asarray(lanes["jax"][1].solved)
    assert (solved[1] != solved[0]).any() and (solved[3] != solved[0]).any()
    poses = np.asarray(lanes["jax"][1].poses)
    assert np.abs(poses[2] - poses[0]).max() > 1e-5


def test_lanes_match_jax_vmap(lanes):
    es_t, out_t = lanes["port"]
    es_j, out_j = lanes["jax"]
    assert out_t.poses.shape == (B, lanes["args"][1].times.shape[1], 7)
    _tree_close(out_t, out_j)
    # The state holds informations up to ~1e12: relative there, as
    # test_torch_fusion holds the single-lane engine.
    _tree_close(es_t, es_j, rtol=1e-8)


def test_each_lane_equals_the_single_lane_run(lanes):
    cfg = _t(lanes["cfg"])
    es_t, out_t = lanes["port"]
    for b in range(B):
        lane = _tree.tree_map(lambda x: x[b], _t(lanes["args"]))
        es1, out1 = TFU.run(cfg, *lane)
        _tree_close(out_t._replace(**{f: getattr(out_t, f)[b]
                                      for f in out_t._fields}),
                    convert.to_numpy(out1))
        _tree_close(_tree.tree_map(lambda x: x[b], es_t),
                    convert.to_numpy(es1), rtol=1e-8)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_lane_ops_per_event_do_not_grow_with_lanes():
    """One set of ops per event for all lanes: aten ops per event at B = 8
    within 2% of B = 2 and at most 1.5× B = 1 (a per-lane loop would be 4×
    and 8×), with every vmap batching rule present (the fallback warning,
    a per-lane loop inside, is an error)."""
    cfg, es, tl, imu = _tiny_problem(n_events=3, n_imu=32)
    one = _t((es, tl, *imu))
    E = tl.times.shape[0]
    per_event = {}
    for lanes_n in (1, 2, 8):
        args = _tree.tree_map(
            lambda x: x.expand((lanes_n,) + x.shape).clone(), one)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=FALLBACK)
            with _OpCount() as c:
                TFU.run_lanes(_t(cfg), *args)
        per_event[lanes_n] = c.n / E
    assert abs(per_event[8] - per_event[2]) <= 0.02 * per_event[2], per_event
    assert per_event[8] <= 1.5 * per_event[1], per_event


# ---------------------------------------------------------------------------
# Two ranks: the data axis, the VIL step, the metric series
# ---------------------------------------------------------------------------

def _ranks_worker(rank, inp, out_path):
    """The data axis's functions on this world's ranks; rank 0 saves the
    results."""
    mesh = TPAR.make_mesh(n_data=dist.get_world_size(), n_model=1,
                          devices="cpu")
    # The same world's rank 0 alone: a one-rank grid (rank 1 sits out).
    one = TPAR.make_mesh(n_data=1, n_model=1, devices="cpu")
    out = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        out["lanes"] = TPAR.batched_fusion_run(mesh, inp["fusion_cfg"])(
            *inp["lanes"])
        if one.coords is not None:
            out["lanes_one_rank"] = TPAR.batched_fusion_run(
                one, inp["fusion_cfg"])(*inp["lanes"])
        step = make_vil_step(mesh, inp["fusion_cfg"])
        out["vil_step"] = step(*inp["lanes"], inp["gt"], *inp["normal_eqs"])
    out["metrics"] = TPAR.sharded_metric_series(mesh, METRIC_NAMES)(
        inp["mats"])
    try:
        TPAR.make_mesh(n_data=dist.get_world_size() + 1, devices="cpu")
    except ValueError as e:
        out["too_many_ranks"] = str(e)
    if rank == 0:
        _dump(out_path, out)


@pytest.fixture(scope="module")
def problems(lanes):
    gt = np.asarray(lanes["jax"][1].poses) + 0.01
    rng = np.random.default_rng(3)
    mats = rng.standard_normal((B, 5, 6, 6))
    mats = mats @ np.swapaxes(mats, -1, -2) + 0.1 * np.eye(6)
    normal_eqs = (rng.standard_normal((64, 1)),
                  rng.standard_normal((64, 1, 6)), rng.uniform(0, 1, 64))
    return dict(fusion_cfg=lanes["cfg"], lanes=lanes["args"], gt=gt,
                normal_eqs=normal_eqs, mats=mats)


@pytest.fixture(scope="module")
def two_ranks(problems, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    inp = {k: _t(v) for k, v in problems.items()}
    spawn(_ranks_worker, RANKS, tmp, inp, tmp / "out.pkl")
    return _load(tmp / "out.pkl")


def test_batched_fusion_run_on_two_ranks_matches_jax_and_one_rank(
        lanes, two_ranks):
    """Two data ranks of 2 lanes each return the whole batch, equal to the
    JAX vmap and to the same function on a one-rank grid."""
    es2, out2 = two_ranks["lanes"]
    _tree_close(out2, lanes["jax"][1])
    _tree_close(es2, lanes["jax"][0], rtol=1e-8)
    es1, out1 = two_ranks["lanes_one_rank"]
    _tree_close(out2, convert.to_numpy(out1))
    _tree_close(es2, convert.to_numpy(es1), rtol=1e-8)


def test_vil_step_on_two_ranks_matches_jax(lanes, problems, two_ranks):
    """make_vil_step: the fused outputs as the JAX vmap; the global ATE
    over both ranks' lanes tight against the same sum over the gathered
    poses, and within the poses' band of JAX's; the ICP reduction as JAX's
    unsharded normal equations."""
    es, out, ate, (H, g) = two_ranks["vil_step"]
    _tree_close(out, lanes["jax"][1])
    gt = problems["gt"]

    def ate_of(p):
        return np.sqrt(np.mean(np.sum((p[..., 4:] - gt[..., 4:]) ** 2, -1)))
    _close(float(ate), ate_of(out.poses.numpy()), rtol=1e-12, atol=0.0)
    _close(float(ate), ate_of(np.asarray(lanes["jax"][1].poses)))
    H_j, g_j, _ = JI.accumulate_normal_eqs(*map(jnp.asarray,
                                                problems["normal_eqs"]))
    _close(H.numpy(), H_j, rtol=1e-10, atol=0.0)
    _close(g.numpy(), g_j, rtol=1e-10, atol=0.0)


def test_sharded_metric_series_on_two_ranks_matches_jax(problems, two_ranks):
    sj = jax.vmap(lambda m: JDG.score_series(METRIC_NAMES, m))(
        jnp.asarray(problems["mats"]))
    st = two_ranks["metrics"]
    assert set(st) == set(METRIC_NAMES)
    for name in METRIC_NAMES:
        assert st[name].score_all.shape == (B, 5)
        for f in sj[name]._fields:
            a, b = getattr(st[name], f).numpy(), _np(getattr(sj[name], f))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            _close(a, b, rtol=1e-9, atol=1e-9, msg=f"{name}.{f}")


def test_a_mesh_larger_than_the_world_raises(two_ranks):
    assert "needs 3 ranks; this world has 2" in two_ranks["too_many_ranks"]

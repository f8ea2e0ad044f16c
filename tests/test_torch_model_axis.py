"""The port's ``parallel`` model axis against the JAX package, in float64
on identical inputs: two gloo processes (``torch.multiprocessing.spawn``,
a ``file://`` store under ``tmp_path``) run ``sharded_normal_eqs``,
``make_sharded_register`` (odd query counts, so the padding is exercised)
and ``make_sharded_lidar_step`` (a raycast sweep against a map seeded by
the sweep before, as ``__graft_entry__.dryrun_multichip`` sets it up).
Each is held against the JAX package's unsharded function and the port's
own. A sum split over ranks differs only in summation order: rtol 1e-10 on
H and g, ``n_corr`` exact."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends.lidar import icp as JI
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch import parallel as TPAR
from vil_sensor_fusion_tpu_torch.core import lie as TL
from vil_sensor_fusion_tpu_torch.data import raycast as TR
from vil_sensor_fusion_tpu_torch.frontends import lidar as TLi
from vil_sensor_fusion_tpu_torch.frontends.lidar import features as TF
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as TV

DT = torch.float64
RANKS = 2


def _np(x):
    return np.asarray(x)


def _jax(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)),
                                  convert.to_numpy(tree))


def _close(a, b, atol=1e-10, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


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


def _pose(x=0.0, y=0.0, z=1.5):
    return torch.tensor([1.0, 0, 0, 0, x, y, z], dtype=DT)


def _register_problem():
    """Scan-to-map registration of a raycast sweep against a map built from
    the sweep before (test_torch_lidar's setup). The query sets are cut to
    odd counts, so the sharded register pads them."""
    world = TR.town_world(n_boxes=24, seed=2, dtype=DT, device="cpu")
    p0 = _pose()
    p1 = TL.pose_retract(p0, torch.tensor([0.3, 0.1, 0.02, 0.0, 0.0, 0.03],
                                          dtype=DT))
    f0 = TF.extract(TR.raycast(world, p0))
    f1 = TF.extract(TR.raycast(world, p1))

    def map_from(pts, mask, leaf, capacity):
        c = TV.VoxelMapConfig(capacity=capacity, leaf=leaf)
        w = TL.quat_rotate(TL.pose_quat(p0)[None], pts) + TL.pose_trans(p0)
        m = TV.insert(TV.empty(c, DT, "cpu"), w, mask, TL.pose_trans(p0), c)
        return m.points, m.mask

    mc, mcm = map_from(f0.less_sharp, f0.less_sharp_mask, 0.2, 4096)
    ms, msm = map_from(torch.cat([f0.flat, f0.less_flat]),
                       torch.cat([f0.flat_mask, f0.less_flat_mask]), 0.4,
                       8192)
    qs = torch.cat([f1.flat, f1.less_flat])
    qsm = torch.cat([f1.flat_mask, f1.less_flat_mask])
    nc = f1.less_sharp.shape[0] - 1 + f1.less_sharp.shape[0] % 2
    ns = qs.shape[0] - 1 + qs.shape[0] % 2
    args = (p0, f1.less_sharp[:nc], f1.less_sharp_mask[:nc], qs[:ns],
            qsm[:ns], mc, mcm, ms, msm)
    cfg = TLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                        final_refresh=False, eig_sweeps=3)
    return cfg, args


def _lidar_step_problem():
    """Two raycast sweeps, the first seeding the map, as
    ``__graft_entry__.dryrun_multichip`` sets them up (narrow maps;
    single-stage and no undistortion, as the JAX package's own sharded
    step test)."""
    cfg = TLi.LidarOdomConfig(
        icp=TLi.IcpConfig(iters=2, degen_eigval=5.0),
        corner_map=TV.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=TV.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024, two_stage=False,
        undistort=False)
    world = TR.town_world(n_boxes=8, seed=1, dtype=DT, device="cpu")
    p0, p1 = _pose(), _pose(x=0.3)
    return cfg, (TR.raycast(world, p0), p0), (TR.raycast(world, p1), p1)


def _normal_eq_problem():
    rng = np.random.default_rng(0)
    N = 1024
    return tuple(torch.as_tensor(x) for x in (
        rng.standard_normal((N, 1)), rng.standard_normal((N, 1, 6)),
        rng.uniform(0.0, 1.0, N)))


def _model_worker(rank, inp, out_path):
    mesh = TPAR.make_mesh(n_data=1, n_model=dist.get_world_size(),
                          devices="cpu")
    out = {"normal_eqs": TPAR.sharded_normal_eqs(mesh)(*inp["normal_eqs"])}
    rcfg, rargs = inp["register"]
    out["register"] = TPAR.make_sharded_register(mesh, rcfg)(*rargs)
    lcfg, (sw0, p0), (sw1, p1) = inp["lidar"]
    step = TPAR.make_sharded_lidar_step(mesh, lcfg)
    st = TLi.odometry.init(lcfg, DT, device="cpu")
    st, _ = step(st, sw0, p0)
    out["lidar_step"] = step(st, sw1, p1)[1]
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def problems():
    return dict(normal_eqs=_normal_eq_problem(),
                register=_register_problem(), lidar=_lidar_step_problem())


@pytest.fixture(scope="module")
def two_ranks(problems, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model")
    spawn(_model_worker, RANKS, tmp, problems, tmp / "out.pkl")
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def _check_icp_result(rt, ref):
    """Pose and H within summation order (rtol 1e-10), n_corr exact."""
    _close(rt.pose.numpy(), _np(ref.pose))
    _close(rt.hessian.numpy(), _np(ref.hessian), rtol=1e-10)
    assert float(rt.n_corr) == float(ref.n_corr)
    np.testing.assert_array_equal(rt.degenerate.numpy(), _np(ref.degenerate))


def test_sharded_normal_eqs_on_two_ranks_match_jax(problems, two_ranks):
    H_j, g_j, _ = JI.accumulate_normal_eqs(*_jax(problems["normal_eqs"]))
    H_t, g_t = two_ranks["normal_eqs"]
    _close(H_t.numpy(), H_j, rtol=1e-10, atol=0.0)
    _close(g_t.numpy(), g_j, rtol=1e-10, atol=0.0)


def test_sharded_register_on_two_ranks_matches_jax_and_port(problems,
                                                            two_ranks):
    cfg, args = problems["register"]
    assert args[1].shape[0] % RANKS and args[3].shape[0] % RANKS
    jcfg = JLi.IcpConfig(**cfg._asdict())
    rj = jax.jit(lambda *a: JI.register(*a, jcfg))(*_jax(args))
    rt = two_ranks["register"]
    _check_icp_result(rt, rj)
    _check_icp_result(rt, TLi.register(*args, cfg))
    assert float(rt.n_corr) > 100


def test_sharded_lidar_step_on_two_ranks_matches_jax_and_port(problems,
                                                              two_ranks):
    cfg, (sw0, p0), (sw1, p1) = problems["lidar"]
    jcfg = _jax_config(cfg)
    jstep = jax.jit(lambda st, sw, p: JLi.odometry.step(jcfg, st, sw, p))
    st = JLi.odometry.init(jcfg, jnp.float64)
    st, _ = jstep(st, *_jax((sw0, p0)))
    _, rj = jstep(st, *_jax((sw1, p1)))
    st_t = TLi.odometry.init(cfg, DT, device="cpu")
    st_t, _ = TLi.odometry.step(cfg, st_t, sw0, p0)
    _, rp = TLi.odometry.step(cfg, st_t, sw1, p1)
    rt = two_ranks["lidar_step"]
    for ref in (rj, rp):
        _check_icp_result(rt, ref)
        _close(rt.odom_pose.numpy(), _np(ref.odom_pose))
        _close(rt.cov.numpy(), _np(ref.cov), rtol=1e-8, atol=1e-12)
    assert float(rt.n_corr) > 100


def _jax_config(cfg):
    """The JAX package's LidarOdomConfig with the port config's values."""
    from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JV

    kw = cfg._asdict()
    kw["icp"] = JLi.IcpConfig(**cfg.icp._asdict())
    kw["odom_icp"] = JLi.IcpConfig(**cfg.odom_icp._asdict())
    kw["corner_map"] = JV.VoxelMapConfig(**cfg.corner_map._asdict())
    kw["surf_map"] = JV.VoxelMapConfig(**cfg.surf_map._asdict())
    return JLi.LidarOdomConfig(**kw)

"""Parity of the port's LiDAR front-end with the JAX package, in float32 on
identical inputs: sweeps raycast by the JAX package from a JAX town world
and handed to both sides as numpy (``convert.to_torch``).

Tolerances: poses ~1e-4 m / rad. Hessians within 5e-2 relative (Frobenius
norm) and ``n_corr`` atol 8, like ``__graft_entry__.py:158-168``: a line or
plane eligibility gate can flip for a few correspondences of thousands
under f32 reassociation, and one flip moves the small off-diagonal entries
of H by far more than 5% of themselves."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import raycast as JR
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends.lidar import features as JF
from vil_sensor_fusion_tpu.frontends.lidar import rangeimage as JRI
from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JV
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.frontends import lidar as TLi
from vil_sensor_fusion_tpu_torch.frontends.lidar import features as TF
from vil_sensor_fusion_tpu_torch.frontends.lidar import rangeimage as TRI
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as TV

DT = jnp.float32


def _pose(x=0.0, y=0.0, z=1.5, yaw=0.0):
    q = JL.so3_exp_quat(jnp.array([0.0, 0.0, yaw], DT))
    return JL.pose_make(q, jnp.array([x, y, z], DT))


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _np(x):
    return np.asarray(x)


def _assert_hessians_close(Ht, Hj):
    """Per-Hessian ‖Ht − Hj‖_F ≤ 5e-2 ‖Hj‖_F."""
    Ht, Hj = np.asarray(Ht, np.float64), np.asarray(Hj, np.float64)
    err = np.linalg.norm(Ht - Hj, axis=(-2, -1))
    scale = np.linalg.norm(Hj, axis=(-2, -1))
    assert (err <= 5e-2 * scale + 1e-6).all(), (err, scale)


@pytest.fixture(scope="module")
def world():
    return JR.town_world(n_boxes=24, seed=2, dtype=DT)


@pytest.fixture(scope="module")
def sweep0(world):
    return JR.raycast(world, _pose())


def test_extract_matches_jax(sweep0):
    fj = JF.extract(sweep0)
    ft = TF.extract(_t(sweep0))
    for name in fj._fields:
        a, b = getattr(ft, name).numpy(), _np(getattr(fj, name))
        if name.endswith("mask"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=name)


def test_undistort_matches_jax(sweep0):
    xi = np.array([0.4, 0.05, 0.0, 0.0, 0.0, 0.03], np.float32)
    sj = JRI.undistort(sweep0, jnp.asarray(xi))
    st = TRI.undistort(_t(sweep0), torch.from_numpy(xi))
    np.testing.assert_allclose(st.xyz.numpy(), _np(sj.xyz), atol=2e-5)


def _occupied(m):
    pts, mask = _np(m.points), _np(m.mask)
    slots = np.nonzero(mask > 0)[0]
    return slots, pts[slots]


@pytest.mark.parametrize("offset", [0.0, 5000.0])
def test_insert_hashed_matches_jax_as_slot_sets(world, offset):
    """Two sweeps' surface pools through insert_hashed. Compared as the SET
    of occupied slots and their points: several winners of one slot land
    in backend order in XLA (the port takes the lowest index). The 5 km
    offset drives the int32 hash products through wrap-around."""
    cfg = JV.VoxelMapConfig(capacity=4096, leaf=0.4, keep_radius=150.0)
    mj = JV.empty(cfg, DT)
    mt = TV.empty(_t(cfg), torch.float32, device="cpu")
    for x in (0.0, 0.8):
        p = _pose(x=x)
        fs = JF.extract(JR.raycast(world, p))
        pts = jnp.concatenate([fs.flat, fs.less_flat]) + offset
        msk = jnp.concatenate([fs.flat_mask, fs.less_flat_mask])
        w = JL.quat_rotate(JL.pose_quat(p)[None], pts) + JL.pose_trans(p)
        center = JL.pose_trans(p) + offset
        mj = JV.insert_hashed(mj, w, msk, center, cfg)
        mt = TV.insert_hashed(mt, *(_t((w, msk, center))), _t(cfg))
    sj, pj = _occupied(mj)
    st, pt = _occupied(mt)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_allclose(pt, pj, atol=1e-6)


def test_voxel_hash_wraps_int32_and_floors_modulo():
    """The hash of far voxels overflows int32 (wraps like XLA) and is often
    negative; the slot is the floor-modulo (torch.remainder), never fmod."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3e4, 3e4, (4000, 3)).astype(np.float32)
    cfg = JV.VoxelMapConfig(capacity=1021, leaf=0.4, keep_radius=1e6)
    mj = JV.insert_hashed(JV.empty(cfg, DT), jnp.asarray(pts),
                          jnp.ones(4000, DT), jnp.zeros(3, DT), cfg)
    mt = TV.insert_hashed(TV.empty(_t(cfg), device="cpu"),
                          torch.from_numpy(pts),
                          torch.ones(4000), torch.zeros(3), _t(cfg))
    g = np.floor(pts / 0.4).astype(np.int64)
    h = ((g[:, 0] * 73856093) ^ (g[:, 1] * 19349663) ^ (g[:, 2] * 83492791))
    assert (h.astype(np.int32) < 0).any()        # wrap-around happened
    np.testing.assert_array_equal(_occupied(mt)[0], _occupied(mj)[0])


@pytest.mark.parametrize("budget", [64, 700])
def test_submap_matches_jax(world, budget):
    cfg = JV.VoxelMapConfig(capacity=2048, leaf=0.4)
    fs = JF.extract(JR.raycast(world, _pose()))
    m = JV.insert_hashed(JV.empty(cfg, DT), fs.less_flat, fs.less_flat_mask,
                         jnp.array([0.0, 0.0, 1.5], DT), cfg)
    center = np.array([1.0, 0.5, 1.5], np.float32)
    sj = JV.submap(m, jnp.asarray(center), budget, 30.0, approx=False)
    stt = TV.submap(_t(m), torch.from_numpy(center), budget, 30.0)
    np.testing.assert_array_equal(stt.mask.numpy(), _np(sj.mask))
    np.testing.assert_allclose(stt.points.numpy(), _np(sj.points), atol=0)


def test_topk_ties_resolve_to_lowest_index():
    """Exact ties (and the −inf of every ineligible entry) pick the lowest
    index, as lax.top_k does."""
    score = np.zeros((2, 60), np.float32)
    score[0, [3, 7, 8, 40]] = 1.0
    ok = np.ones((2, 60), np.float32)
    ok[1] = 0.0
    fj, okj = JF._select_region_topk(jnp.asarray(score), jnp.asarray(ok), 3)
    ft, okt = TF._select_region_topk(torch.from_numpy(score),
                                     torch.from_numpy(ok), 3)
    np.testing.assert_array_equal(ft.numpy(), _np(fj))
    np.testing.assert_array_equal(okt.numpy(), _np(okj))
    pts = np.zeros((10, 3), np.float32)
    pts[[2, 5, 6], 0] = 1.0                       # three equidistant points
    mask = np.ones(10, np.float32)
    mask[0] = 0.0
    mj = JV.VoxelMap(points=jnp.asarray(pts), mask=jnp.asarray(mask))
    sj = JV.submap(mj, jnp.zeros(3, DT), 6, approx=False)
    stt = TV.submap(_t(mj), torch.zeros(3), 6)
    np.testing.assert_array_equal(stt.points.numpy(), _np(sj.points))
    np.testing.assert_array_equal(stt.mask.numpy(), _np(sj.mask))


def _map_from(fs, pose, leaf, capacity):
    cfg = JV.VoxelMapConfig(capacity=capacity, leaf=leaf)
    w = JL.quat_rotate(JL.pose_quat(pose)[None], fs[0]) + JL.pose_trans(pose)
    m = JV.insert(JV.empty(cfg, w.dtype), w, fs[1], JL.pose_trans(pose), cfg)
    return m.points, m.mask


@pytest.mark.parametrize("schedule", ["classic", "main_path"])
def test_register_matches_jax(world, schedule):
    p0 = _pose()
    p1 = JL.pose_retract(p0, jnp.asarray([0.3, 0.1, 0.02, 0.0, 0.0, 0.03],
                                         DT))
    f0 = JF.extract(JR.raycast(world, p0))
    f1 = JF.extract(JR.raycast(world, p1))
    mc, mcm = _map_from((f0.less_sharp, f0.less_sharp_mask), p0, 0.2, 4096)
    ms, msm = _map_from((jnp.concatenate([f0.flat, f0.less_flat]),
                         jnp.concatenate([f0.flat_mask, f0.less_flat_mask])),
                        p0, 0.4, 8192)
    if schedule == "classic":
        cfg = JLi.IcpConfig(iters=4, degen_eigval=5.0)
    else:
        cfg = JLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                            final_refresh=False, eig_sweeps=3)
    args = (p0, f1.less_sharp, f1.less_sharp_mask,
            jnp.concatenate([f1.flat, f1.less_flat]),
            jnp.concatenate([f1.flat_mask, f1.less_flat_mask]),
            mc, mcm, ms, msm)
    rj = jax.jit(lambda *a: JLi.register(*a, cfg))(*args)
    rt = TLi.register(*_t(args), _t(cfg))
    np.testing.assert_allclose(rt.pose.numpy(), _np(rj.pose), atol=1e-4)
    _assert_hessians_close(rt.hessian.numpy(), rj.hessian)
    np.testing.assert_allclose(float(rt.n_corr), float(rj.n_corr), atol=8)
    np.testing.assert_array_equal(rt.degenerate.numpy(), _np(rj.degenerate))
    # The registration recovered the motion (sanity of the shared input).
    err = JL.pose_local(p1, jnp.asarray(rt.pose.numpy()))
    assert float(jnp.linalg.norm(err[:3])) < 0.15


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_odometry_run_matches_jax(dtype):
    """A 5-sweep two-stage drive (delta priors, hashed maps) at narrow map
    sizes: poses, Hessians, n_corr and covariances.

    In float64 the two sides agree to round-off (checked at 1e-8). In
    float32 a chain of sweeps is chaotic at the ulp level: XLA's and
    PyTorch's f32 sin/cos differ in the last bit, so undistorted points and
    poses differ by ~1e-6, and sooner or later a LOAM curvature pick, a
    hashed-map slot winner or a line/plane gate flips — in the ~190-point
    scan-to-scan stage one flip moves the pose by millimetres (measured up
    to 6e-3 m over these 5 sweeps). The f32 case is therefore held to
    1e-2 m, with n_corr within 2% + 8.

    Undistortion stays on (the main-path setting) in both cases: on these
    motion-free sweeps every ground ring is exactly equidistant from the
    sensor, so without the warp the hashed map's nearest-wins ties are
    decided by ulps of the pose even in float64."""
    dt = jnp.float64 if dtype == "float64" else jnp.float32
    world = JR.town_world(n_boxes=24, seed=2, dtype=dt)
    T = 5
    xs = np.arange(T) * 0.4
    poses = jnp.stack([_pose(x=x, y=0.05 * x, yaw=0.02 * x)
                       for x in xs]).astype(dt)
    sweeps = JR.sweep_series(world, poses)
    cfg = JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                          final_refresh=False, eig_sweeps=3),
        odom_icp=JLi.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                               fit_every=4, final_refresh=False,
                               eig_sweeps=3),
        corner_map=JV.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=JV.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024,
        two_stage=True, undistort=True, guess_is_delta=True)
    prev = jnp.concatenate([poses[:1], poses[:-1]])
    guesses = jax.vmap(JL.pose_between)(prev, poses)
    st_j = JLi.odometry.init(cfg, dt, pose0=poses[0])
    _, oj = jax.jit(lambda s, sw, g: JLi.odometry.run(cfg, s, sw, g))(
        st_j, sweeps, guesses)
    _, ot = TLi.odometry.run(_t(cfg), _t(st_j), _t(sweeps), _t(guesses))
    assert ot.pose.dtype == (torch.float64 if dtype == "float64"
                             else torch.float32)
    if dtype == "float64":
        pose_tol, h_tol, n_rtol, n_tol = 1e-8, 1e-8, 0, 0
    else:
        pose_tol, h_tol, n_rtol, n_tol = 1e-2, 5e-2, 2e-2, 8
    np.testing.assert_allclose(ot.pose.numpy(), _np(oj.pose), atol=pose_tol)
    np.testing.assert_allclose(ot.odom_pose.numpy(), _np(oj.odom_pose),
                               atol=pose_tol)
    Ht, Hj = ot.hessian.numpy(), _np(oj.hessian)
    err = np.linalg.norm(Ht - Hj, axis=(-2, -1))
    assert (err <= h_tol * np.linalg.norm(Hj, axis=(-2, -1)) + 1e-6).all(), err
    np.testing.assert_allclose(ot.n_corr.numpy(), _np(oj.n_corr),
                               rtol=n_rtol, atol=n_tol)
    if dtype == "float64":
        # cov = σ²H⁻¹: meaningful only where nothing flipped.
        np.testing.assert_allclose(ot.cov.numpy(), _np(oj.cov), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("kind", ["corridor", "town"])
def test_perturbation_dists_match_jax(kind):
    """The 6×15 perturbation-sweep distances at a registered pose, in
    float64, from a JAX-built sweep and map: the fits (one k-NN each) are
    taken once, then all 90 perturbed poses at once. Same arithmetic on
    both sides: 1e-9. The shifts are ``jnp.linspace``'s values."""
    dt = jnp.float64
    world = (JR.corridor_world(dtype=dt) if kind == "corridor"
             else JR.town_world(n_boxes=24, seed=2, dtype=dt))
    p0 = _pose().astype(dt)
    p1 = JL.pose_retract(p0, jnp.asarray([0.4, 0.05, 0.0, 0.0, 0.0, 0.02],
                                         dt))
    f0 = JF.extract(JR.raycast(world, p0))
    f1 = JF.extract(JR.raycast(world, p1))
    mc, mcm = _map_from((f0.less_sharp, f0.less_sharp_mask), p0, 0.2, 4096)
    ms, msm = _map_from((jnp.concatenate([f0.flat, f0.less_flat]),
                         jnp.concatenate([f0.flat_mask, f0.less_flat_mask])),
                        p0, 0.4, 8192)
    args = (p1, f1.less_sharp, f1.less_sharp_mask,
            jnp.concatenate([f1.flat, f1.less_flat]),
            jnp.concatenate([f1.flat_mask, f1.less_flat_mask]),
            mc, mcm, ms, msm)
    icfg = JLi.IcpConfig(iters=6, degen_eigval=5.0)
    dj = jax.jit(lambda *a: JLi.icp.perturbation_dists(*a, icfg))(*args)
    dtt = TLi.icp.perturbation_dists(*convert.to_torch(args, "cpu"),
                                     _t(icfg))
    for f in dj._fields:
        np.testing.assert_allclose(getattr(dtt, f).numpy(),
                                   _np(getattr(dj, f)), rtol=1e-9, atol=1e-9,
                                   err_msg=f)
    np.testing.assert_array_equal(dtt.shift_trans.numpy(),
                                  np.asarray(jnp.linspace(0.0, 0.2, 15)))
    assert float(dtt.dists[:, -1].min()) > 0.0


def test_odometry_emits_dists_like_jax():
    """``emit_dists``: the stacked ``dists`` of a 3-sweep float64 drive
    equal JAX's (zeros on the map-seeding first sweep); without it the
    field is zero-filled, as JAX's ``_zero_dists``."""
    dt = jnp.float64
    world = JR.town_world(n_boxes=24, seed=2, dtype=dt)
    poses = jnp.stack([_pose(x=0.4 * i, y=0.02 * i, yaw=0.02 * i)
                       for i in range(3)]).astype(dt)
    sweeps = JR.sweep_series(world, poses)
    prev = jnp.concatenate([poses[:1], poses[:-1]])
    guesses = jax.vmap(JL.pose_between)(prev, poses)
    cfg = JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=2, degen_eigval=5.0),
        odom_icp=JLi.IcpConfig(iters=2, max_corr_dist=2.0, degen_eigval=5.0),
        corner_map=JV.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=JV.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024, emit_dists=True,
        dists_shifts=7, guess_is_delta=True)
    st = JLi.odometry.init(cfg, dt, pose0=poses[0])
    _, oj = JLi.odometry.run(cfg, st, sweeps, guesses)
    _, ot = TLi.odometry.run(_t(cfg), _t(st), _t(sweeps), _t(guesses))
    np.testing.assert_allclose(ot.pose.numpy(), _np(oj.pose), atol=1e-8)
    assert tuple(ot.dists.dists.shape) == (3, 6, 7)
    for f in oj.dists._fields:
        np.testing.assert_allclose(getattr(ot.dists, f).numpy(),
                                   _np(getattr(oj.dists, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    assert bool((ot.dists.dists[1:] > 0).all())
    c = _t(cfg._replace(emit_dists=False))
    _, off = TLi.odometry.run(c, _t(st), _t(sweeps), _t(guesses))
    zj = JLi.odometry._zero_dists(cfg, dt)
    for f in zj._fields:
        want = np.broadcast_to(_np(getattr(zj, f)),
                               (3,) + _np(getattr(zj, f)).shape)
        np.testing.assert_array_equal(getattr(off.dists, f).numpy(), want)

"""The port's lane-batched stages against ``jax.vmap`` of the JAX stage
functions, as the JAX round's ``bench.py`` maps them over distinct
sequences: ``odometry.run_lanes``, ``pipeline.run_lanes``,
``frontend.track_frames_lanes`` (with ``pyramids_batch`` and
``candidates_batch`` over (B, T, ·)), ``gate.logdet_gate`` over lanes and
the bench's double-mapped ``pose_between`` priors. Lanes are 2-3 distinct
inputs made from numpy seeds (worlds, renders, sweeps and synthetic
tracks made by the port, whose makers the other test files pin to JAX's,
and handed to both sides as the same numbers); each lane is also held
against its own single-lane run of the port. Every ``vmap`` batching-rule fallback (a
per-lane loop in disguise) is an error, and the aten ops per VIO frame, per
LiDAR sweep and per tracked frame at B = 2 stay within 1.3× of B = 1.

Tolerances: as the single-lane parity tests of the same functions
(``test_torch_lidar.py``, ``test_torch_vio.py``, ``test_torch_tracker.py``)
and stated with each test."""

import contextlib
import functools
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JV
from vil_sensor_fusion_tpu.frontends.vio import camera as JC
from vil_sensor_fusion_tpu.frontends.vio import ekf as JE
from vil_sensor_fusion_tpu.frontends.vio import frontend as JF
from vil_sensor_fusion_tpu.frontends.vio import pipeline as JP
from vil_sensor_fusion_tpu_torch import _tree, bench, convert
from vil_sensor_fusion_tpu_torch.core import lie as TL
from vil_sensor_fusion_tpu_torch.data import raycast as TR
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC
from vil_sensor_fusion_tpu_torch.degeneracy import gate as TDG
from vil_sensor_fusion_tpu_torch.frontends import lidar as TLi
from vil_sensor_fusion_tpu_torch.frontends.vio import ekf as TE
from vil_sensor_fusion_tpu_torch.frontends.vio import frontend as TF
from vil_sensor_fusion_tpu_torch.frontends.vio import pipeline as TP
from vil_sensor_fusion_tpu_torch.frontends.vio import synthetic as TS

FALLBACK = ".*performance drop.*batching rule.*"
M = 10          # landmark slots
F64 = jnp.float64


def _t(tree, dtype=None):
    return convert.to_torch(tree, "cpu", dtype)


def _j(tree, cls):
    """A tree of the port's tensors as the JAX package's ``cls`` of
    arrays."""
    return cls(*(jnp.asarray(x.numpy()) for x in tree))


def _stack(trees):
    return _tree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _lane(tree, b):
    return _tree.tree_map(lambda x: x[b], tree)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small ops: one intra-op thread runs them as
    fast as eight here and leaves the other cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _no_fallback():
    """A ``vmap`` batching-rule fallback warning raises inside."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        yield


@pytest.fixture(autouse=True)
def no_batching_fallback():
    with _no_fallback():
        yield


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn, *args) -> int:
    with _OpCount() as c:
        fn(*args)
    return c.n


def _first_lanes(tree, n):
    return _tree.tree_map(lambda x: x[:n].clone(), tree)


# ---------------------------------------------------------------------------
# LiDAR odometry
# ---------------------------------------------------------------------------

LANES_LIDAR = 2
T_SWEEPS = 4


def _lidar_cfg():
    """test_torch_lidar.py:test_odometry_run_matches_jax's narrow maps."""
    return JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                          final_refresh=False, eig_sweeps=3),
        odom_icp=JLi.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                               fit_every=4, final_refresh=False,
                               eig_sweeps=3),
        corner_map=JV.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=JV.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024,
        two_stage=True, undistort=True, guess_is_delta=True)


# Per lane: (town world seed, speed m per sweep, lateral drift, yaw rate).
# In float64 the port's and JAX's single-lane runs agree to round-off only
# where no curvature pick or hashed-map slot is tied to an ulp, so lanes
# are drives where they agree.
DRIVES = ((2, 0.4, 0.05, 0.02), (3, 0.357, -0.071, -0.007))


@functools.lru_cache(maxsize=None)
def _lidar_case(dtype: str):
    """Lane b: its own town world and drive (``DRIVES``), raycast by the
    port and handed to both sides as the same numbers; JAX runs
    ``jax.vmap`` of its ``odometry.run`` over them."""
    tdt = getattr(torch, dtype)
    cfg = _lidar_cfg()
    states, sweeps, guesses = [], [], []
    for seed, v, drift, yaw in DRIVES[:LANES_LIDAR]:
        world = TR.town_world(n_boxes=24, seed=seed, dtype=tdt, device="cpu")
        xs = torch.arange(T_SWEEPS, dtype=tdt) * v
        zero = torch.zeros_like(xs)
        poses = TL.pose_make(
            TL.so3_exp_quat(torch.stack([zero, zero, yaw * xs], -1)),
            torch.stack([xs, drift * xs, zero + 1.5], -1))
        sweeps.append(TR.sweep_series(world, poses))
        guesses.append(TL.pose_between(torch.cat([poses[:1], poses[:-1]]),
                                       poses))
        states.append(JLi.odometry.init(cfg, getattr(jnp, dtype),
                                        pose0=jnp.asarray(poses[0].numpy())))
    st = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states)
    sw, g = _stack(sweeps), torch.stack(guesses)
    _, oj = jax.jit(jax.vmap(
        lambda s, w, p: JLi.odometry.run(cfg, s, w, p)))(
        st, _j(sw, JLi.Sweep), jnp.asarray(g.numpy()))
    args = (_t(cfg), _t(st), sw, g)
    with _no_fallback():
        _, ot = TLi.odometry.run_lanes(*args)
    return dtype, args, oj, ot


@pytest.fixture(params=["float64", "float32"])
def lidar_lanes(request):
    return _lidar_case(request.param)


def test_odometry_run_lanes_matches_jax_vmap(lidar_lanes):
    """In float64 to 1e-8 (poses, Hessians relative, covariances); in
    float32 at the single-lane test's band: 1e-2 m, Hessians 5e-2 of
    their norm, n_corr 2% + 8 (an f32 chain of sweeps flips a curvature
    pick or a line/plane gate sooner or later; test_torch_lidar.py)."""
    dtype, _, oj, ot = lidar_lanes
    assert ot.pose.shape == (LANES_LIDAR, T_SWEEPS, 7)
    assert ot.pose.dtype == getattr(torch, dtype)
    if dtype == "float64":
        pose_tol, h_tol, n_rtol, n_tol = 1e-8, 1e-8, 0, 0
    else:
        pose_tol, h_tol, n_rtol, n_tol = 1e-2, 5e-2, 2e-2, 8
    _close(ot.pose.numpy(), oj.pose, pose_tol)
    _close(ot.odom_pose.numpy(), oj.odom_pose, pose_tol)
    Ht, Hj = ot.hessian.numpy(), np.asarray(oj.hessian)
    err = np.linalg.norm(Ht - Hj, axis=(-2, -1))
    assert (err <= h_tol * np.linalg.norm(Hj, axis=(-2, -1)) + 1e-6).all()
    np.testing.assert_allclose(ot.n_corr.numpy(), np.asarray(oj.n_corr),
                               rtol=n_rtol, atol=n_tol)
    if dtype == "float64":
        np.testing.assert_allclose(ot.cov.numpy(), np.asarray(oj.cov),
                                   rtol=1e-6, atol=1e-12)
    # The lanes differ: distinct worlds and drives.
    assert np.abs(np.diff(ot.n_corr.numpy(), axis=0)).max() > 0


def test_each_lidar_lane_equals_its_single_run(lidar_lanes):
    """Lane b of run_lanes against odometry.run on lane b alone: the same
    ops on the same values, batched or not. f64 to 1e-10 m and 1e-10 of
    the Hessian's norm, n_corr exact. In f32 a batched product may sum in
    another order, and the chain of sweeps amplifies an ulp into a flipped
    pick or gate as it does between the port and JAX (measured: 1.7 mm
    with one intra-op thread), so f32 is held to the JAX test's band:
    1e-2 m, Hessians 5e-2, n_corr 2% + 8."""
    dtype, (cfg, st, sw, g), _, ot = lidar_lanes
    if dtype == "float64":
        pose_tol, h_tol, n_rtol, n_tol = 1e-10, 1e-10, 0, 0
    else:
        pose_tol, h_tol, n_rtol, n_tol = 1e-2, 5e-2, 2e-2, 8
    for b in range(LANES_LIDAR):
        _, o1 = TLi.odometry.run(cfg, _lane(st, b), _lane(sw, b), g[b])
        _close(ot.pose[b].numpy(), o1.pose.numpy(), pose_tol)
        H1 = o1.hessian.numpy()
        err = np.linalg.norm(ot.hessian[b].numpy() - H1, axis=(-2, -1))
        assert (err <= h_tol * np.linalg.norm(H1, axis=(-2, -1))
                + 1e-6).all()
        np.testing.assert_allclose(ot.n_corr[b].numpy(), o1.n_corr.numpy(),
                                   rtol=n_rtol, atol=n_tol)


# ---------------------------------------------------------------------------
# VIO
# ---------------------------------------------------------------------------

LANES_VIO = 3
T_FRAMES = 6


def _cam():
    return JC.Camera(fx=107.0, fy=107.0, cx=80.0, cy=60.0, width=160,
                     height=120)


@pytest.fixture(scope="module")
def vio_lanes():
    """test_torch_vio.py's synthetic frames along the town drive, made by
    the port (``synthetic.make_frames``, equal to JAX's) and handed to
    both sides; lane b tracks its own landmark field with its own pixel
    noise (seeds 1 + b, 3 + b, 2 + b) from its own initial velocity."""
    f64 = torch.float64
    pose_ic = JF.forward_camera_extrinsics(F64)
    cfg = JE.VioConfig(num_landmarks=M, cam=_cam(),
                       pose_ic=tuple(np.asarray(pose_ic)))
    tcfg = _t(cfg)
    traj = TSC._town_traj()
    times = (np.arange(T_FRAMES) + 1.0) / 20.0
    poses = torch.func.vmap(traj.pose_fn)(torch.tensor(times, dtype=f64))
    imu_w = TS.imu_windows_for_frames(traj, times, imu_hz=200.0, dtype=f64,
                                      device="cpu")
    frames, states = [], []
    t0 = torch.zeros((), dtype=f64)
    for b in range(LANES_VIO):
        lms = TS.landmark_field(400, seed=1 + b, extent=40.0,
                                height=(0.5, 10.0))
        lms[:, 0] = np.random.default_rng(3 + b).uniform(-40.0, 42.0, 400)
        frames.append(TS.make_frames(tcfg, poses.numpy(), imu_w, lms,
                                     seed=2 + b, pixel_noise=0.5))
        states.append(TE.init(tcfg, traj.pose_fn(t0),
                              traj.vel_fn(t0) + 0.05 * b,
                              torch.zeros(6, dtype=f64)))
    ft, st = _stack(frames), _stack(states)
    _, oj = jax.jit(jax.vmap(lambda s, f: JP.run(cfg, s, f)))(
        _j(st, JE.VioState), _j(ft, JP.VioFrameInput))
    args = (tcfg, st, ft)
    with _no_fallback():
        _, ot = TP.run_lanes(*args)
    return args, oj, ot


def test_pipeline_run_lanes_matches_jax_vmap(vio_lanes):
    """Poses and velocities to 1e-9; the covariance outputs to 1e-9 of
    their largest entry (test_torch_vio.py:test_pipeline_run_matches_jax)."""
    _, oj, ot = vio_lanes
    assert ot.pose.shape == (LANES_VIO, T_FRAMES, 7)
    _close(ot.pose.numpy(), oj.pose, 1e-9)
    _close(ot.vel.numpy(), oj.vel, 1e-9)
    for f in ("cov", "twist_cov"):
        c = np.asarray(getattr(oj, f))
        _close(getattr(ot, f).numpy(), c, 1e-9 * np.abs(c).max())
    assert np.abs(np.diff(ot.pose.numpy(), axis=0)).max() > 1e-6


def test_each_vio_lane_equals_its_single_run(vio_lanes):
    (cfg, s, f), _, ot = vio_lanes
    for b in range(LANES_VIO):
        _, o1 = TP.run(cfg, _lane(s, b), _lane(f, b))
        for name in o1._fields:
            a, c = getattr(ot, name)[b].numpy(), getattr(o1, name).numpy()
            _close(a, c, 1e-12 * max(np.abs(c).max(), 1.0))


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------

LANES_TRACK = 2
T_TRACK = 4


def _fcfg():
    return JF.FrontendConfig(cam=_cam(), n_candidates=32, min_dist=10.0,
                             min_score=0.5)


@pytest.fixture(scope="module")
def tracker_lanes():
    """Lane b: T_TRACK frames of its own town world (seed b) rendered by
    the port along the town drive, each frame with the first sweep's
    points in the camera frame; IMU windows from numpy seed 10 + b. Both
    sides take the same numbers. JAX: bench.py:250-252's vmaps of the
    batched phase and the tracker."""
    f64 = torch.float64
    cfg = _fcfg()
    tcfg = _t(cfg)
    traj = TSC._town_traj()
    pose_ic = TF.forward_camera_extrinsics(f64, device="cpu")
    times = torch.arange(1, T_TRACK + 1, dtype=f64) / 20.0
    poses = torch.func.vmap(traj.pose_fn)(times)
    poses_cam = TL.pose_compose(poses, pose_ic)
    imgs, pts, msk, imu = [], [], [], []
    for b in range(LANES_TRACK):
        world = TR.town_world(n_boxes=28, seed=b, dtype=f64, device="cpu")
        imgs.append(TR.render_camera_series(world, poses_cam, tcfg.cam))
        sweep = TR.raycast(world, poses[0])
        p, m = TF.sweep_to_camera(sweep.xyz[:, ::4], sweep.mask[:, ::4],
                                  TL.pose_inverse(pose_ic))
        pts.append(p.expand(T_TRACK, *p.shape))
        msk.append(m.expand(T_TRACK, *m.shape))
        rng = np.random.default_rng(10 + b)
        imu.append((torch.tensor(rng.normal(size=(T_TRACK, 11, 3))),
                    torch.tensor(rng.normal(size=(T_TRACK, 11, 3))),
                    torch.full((T_TRACK, 11), 0.005, dtype=f64)))
    imgs_t, pts_t, msk_t = (torch.stack(x) for x in (imgs, pts, msk))
    imu_t = _stack(imu)
    imgs, pts, msk = (jnp.asarray(x.numpy()) for x in (imgs_t, pts_t, msk_t))
    pyr_j = jax.vmap(lambda im: JF.pyramids_batch(cfg, im))(imgs)
    cand_j = jax.vmap(lambda im, p, v: JF.candidates_batch(cfg, im, p, v))(
        imgs, pts, msk)
    fj = jax.vmap(lambda py, cu, cs, cd, dm, iw: JF.track_frames(
        cfg, py, cu, cs, cd, dm, iw, M)[0])(
        pyr_j, *cand_j, tuple(jnp.asarray(x.numpy()) for x in imu_t))
    with _no_fallback():
        pyr_t = TF.pyramids_batch(tcfg, imgs_t)
        cand_t = TF.candidates_batch(tcfg, imgs_t, pts_t, msk_t)
        ft = TF.track_frames_lanes(tcfg, pyr_t, *cand_t, imu_t, M)
    return ((tcfg, imgs_t, pts_t, msk_t, imu_t), (pyr_j, cand_j, fj),
            (pyr_t, cand_t, ft))


def test_tracker_lanes_match_jax_vmap(tracker_lanes):
    """Pyramids, candidate scores, the projected sweeps and every frame
    field to 1e-9 (test_torch_tracker.py: detections exact, KLT sums
    ~1e-13). Candidate positions and depths are compared where the score
    reaches ``min_score``: a frame with fewer corners than ``n_candidates``
    fills its list with zero-score pixels, whose order the two top-k
    implementations leave to their own tie rules, and which the slot
    assignment never takes (in single-lane runs alike)."""
    _, (pyr_j, cand_j, fj), (pyr_t, cand_t, ft) = tracker_lanes
    for a, b in zip(pyr_t, pyr_j):
        assert a.shape[:2] == (LANES_TRACK, T_TRACK)
        _close(a.numpy(), b, 1e-9)
    score = np.asarray(cand_j[1])
    _close(cand_t[1].numpy(), score, 1e-9)
    _close(cand_t[3].numpy(), cand_j[3], 1e-9)
    real = score >= _fcfg().min_score
    assert real.mean() > 0.5
    _close(cand_t[0].numpy()[real], np.asarray(cand_j[0])[real], 1e-9)
    _close(cand_t[2].numpy()[real], np.asarray(cand_j[2])[real], 1e-9)
    for f in fj._fields:
        _close(getattr(ft, f).numpy(), getattr(fj, f), 1e-9)
    assert float(ft.obs_valid[:, 1:].mean()) > 0.5      # tracks continue


def test_each_tracker_lane_equals_its_single_run(tracker_lanes):
    (cfg, imgs, pts, msk, imu), _, (_, _, ft) = tracker_lanes
    for b in range(LANES_TRACK):
        f1 = TF.build_frames(cfg, imgs[b], pts[b], msk[b],
                             _lane(imu, b), M)
        for name in f1._fields:
            _close(getattr(ft, name)[b].numpy(), getattr(f1, name).numpy(),
                   1e-12)


# ---------------------------------------------------------------------------
# Gate and priors
# ---------------------------------------------------------------------------

def test_logdet_gate_lanes_match_jax_vmap():
    """(B, T, 6, 6) Hessians of three lanes, among them an empty one (log
    det −inf) and a rank-deficient one, against ``jax.vmap`` of the JAX
    gate (bench.py:256-257): scores to 1e-12, keep and valid exact."""
    rng = np.random.default_rng(7)
    B, T = 3, 5
    A = rng.normal(size=(B, T, 6, 12))
    H = A @ np.swapaxes(A, -1, -2) * rng.uniform(1, 1e3, (B, T, 1, 1))
    H[1, 0] = 0.0
    H[2, 3, 2] = H[2, 3, :, 2] = 0.0
    n = rng.integers(0, 3000, (B, T)).astype(np.float64)
    cfg = JDG.GateConfig(rot_threshold=4.0, trans_threshold=-6.0,
                         normalize_per_corr=True)
    gj = jax.vmap(lambda h, c: JDG.logdet_gate(h, cfg, n_corr=c))(
        jnp.asarray(H), jnp.asarray(n))
    gt = TDG.logdet_gate(torch.tensor(H), _t(cfg), torch.tensor(n))
    for f in gj._fields:
        a, b = getattr(gt, f).numpy(), np.asarray(getattr(gj, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        _close(a[fin], b[fin], 1e-12)
        np.testing.assert_array_equal(a[~fin], b[~fin])
    assert 0 < gt.keep.numpy().mean() < 1


def test_delta_guesses_match_jax_double_vmap():
    """The bench's LiDAR priors (bench.py:207-217): the VIO motion between
    consecutive sweep frames of every lane, sweep 0 against the lane's
    initial pose, to 1e-12."""
    rng = np.random.default_rng(8)
    B, Tv = 3, 8
    q = np.asarray(JL.so3_exp_quat(jnp.asarray(rng.normal(0, 0.3,
                                                          (B, Tv + 1, 3)))))
    p = np.concatenate([q, rng.normal(0, 5, (B, Tv + 1, 3))], -1)
    pose0, vio = p[:, 0], p[:, 1:]
    idx = np.arange(1, Tv, 2)
    sel = vio[:, idx]
    prev = np.concatenate([pose0[:, None], sel[:, :-1]], 1)
    want = jax.vmap(jax.vmap(JL.pose_between))(jnp.asarray(prev),
                                              jnp.asarray(sel))
    got = bench.delta_guesses(torch.tensor(vio), torch.tensor(pose0), idx)
    _close(got.numpy(), want, 1e-12)
    one = bench.delta_guesses(torch.tensor(vio[1]), torch.tensor(pose0[1]),
                              idx)
    _close(one.numpy(), want[1], 1e-12)


# ---------------------------------------------------------------------------
# One set of ops per step for all lanes
# ---------------------------------------------------------------------------

def test_ops_per_step_do_not_grow_with_lanes(vio_lanes, tracker_lanes):
    """aten ops per LiDAR sweep, per VIO frame and per tracked frame at
    B = 2 within 1.3× of B = 1 (a per-lane loop would be 2×), counted with
    a ``TorchDispatchMode`` (test_torch_parallel.py's counter)."""
    _, (lcfg, lst, lsw, lg), _, _ = _lidar_case("float64")
    (vcfg, vs, vf), _, _ = vio_lanes
    (fcfg, _, _, _, imu), _, (pyr, cand, _) = tracker_lanes
    per_step = {}
    for B in (1, 2):
        sub = lambda tree: _first_lanes(tree, B)
        per_step[("lidar", B)] = _ops(
            TLi.odometry.run_lanes, lcfg, sub(lst), sub(lsw),
            sub(lg)) / T_SWEEPS
        per_step[("vio", B)] = _ops(TP.run_lanes, vcfg, sub(vs),
                                    sub(vf)) / T_FRAMES
        per_step[("tracker", B)] = _ops(
            TF.track_frames_lanes, fcfg, sub(pyr), *sub(cand), sub(imu),
            M) / T_TRACK
    for stage in ("lidar", "vio", "tracker"):
        assert per_step[(stage, 2)] <= 1.3 * per_step[(stage, 1)], per_step

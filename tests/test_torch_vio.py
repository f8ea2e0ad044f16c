"""Parity of the port's VIO filter (``frontends/vio/camera``, ``ekf``,
``pipeline``, ``synthetic``) with the JAX package, in float64 on identical
numpy inputs, at a 160×120 camera with M = 10 landmark slots.

Tolerance: 1e-9 absolute unless a test states otherwise. Both sides run
the same closed forms in f64; what differs is the summation order inside
matrix products, reductions and the LU solves, ~1e-16 relative per step.
The covariance holds entries up to 1e4 (fresh landmark slots), so it is
compared relative to its largest entry (1e-12 of it). Over the 10-frame
``pipeline.run`` the iterated update amplifies round-off through the
Kalman gain, and the tolerance there is stated with the test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.frontends.vio import camera as JC
from vil_sensor_fusion_tpu.frontends.vio import ekf as JE
from vil_sensor_fusion_tpu.frontends.vio import frontend as JF
from vil_sensor_fusion_tpu.frontends.vio import pipeline as JP
from vil_sensor_fusion_tpu.frontends.vio import synthetic as JS
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC
from vil_sensor_fusion_tpu_torch.frontends.vio import camera as TC
from vil_sensor_fusion_tpu_torch.frontends.vio import ekf as TE
from vil_sensor_fusion_tpu_torch.frontends.vio import pipeline as TP
from vil_sensor_fusion_tpu_torch.frontends.vio import synthetic as TS

DT = jnp.float64
M = 10
ATOL = 1e-9


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _close_state(st, sj):
    """Every field to 1e-9; the covariance to 1e-12 of its largest
    entry."""
    for f in ("pose", "vel", "bias", "landmarks", "lm_valid"):
        _close(getattr(st, f).numpy(), getattr(sj, f))
    cj = np.asarray(sj.cov)
    _close(st.cov.numpy(), cj, atol=1e-12 * np.abs(cj).max() + ATOL)


def _cam():
    return JC.Camera(fx=107.0, fy=107.0, cx=80.0, cy=60.0, width=160,
                     height=120)


def _cfg(**kw):
    pose_ic = JF.forward_camera_extrinsics(DT)
    return JE.VioConfig(num_landmarks=M, cam=_cam(),
                        pose_ic=tuple(np.asarray(pose_ic)), **kw)


def _state(seed=0, n_valid=8):
    """A mid-drive state: pose at 1.5 m moving forward, landmarks 6-20 m
    ahead of the camera, n_valid of them live, a random SPD covariance."""
    rng = np.random.default_rng(seed)
    q = np.asarray(JL.so3_exp_quat(jnp.asarray(
        rng.normal(0, 0.05, 3), DT)))
    pose = np.concatenate([q, [0.3, -0.2, 1.5]])
    lms = np.stack([rng.uniform(6, 20, M), rng.uniform(-5, 5, M),
                    rng.uniform(0.2, 3.0, M)], 1)
    D = 15 + 3 * M
    A = rng.normal(0, 1, (D, D))
    cov = 1e-4 * (A @ A.T) / D + np.diag(
        np.r_[np.full(15, 1e-4), np.full(3 * M, 0.05)])
    valid = np.zeros(M)
    valid[:n_valid] = 1.0
    return JE.VioState(
        pose=jnp.asarray(pose), vel=jnp.asarray([4.0, 0.2, 0.0], DT),
        bias=jnp.asarray(rng.normal(0, 0.01, 6), DT),
        landmarks=jnp.asarray(lms), lm_valid=jnp.asarray(valid),
        cov=jnp.asarray(cov))


def _imu_window(seed=0, n=11, masked=2):
    rng = np.random.default_rng(seed)
    acc = rng.normal(0, 0.3, (n, 3)) + np.array([0.0, 0.0, 9.81])
    gyr = rng.normal(0, 0.05, (n, 3))
    dts = np.full(n, 0.005)
    dts[n - masked:] = 0.0
    return acc, gyr, dts


def test_project_and_backproject_match_jax():
    cam = _cam()
    rng = np.random.default_rng(1)
    p = np.stack([rng.uniform(-8, 8, 200), rng.uniform(-6, 6, 200),
                  rng.uniform(-1, 20, 200)], 1)
    p[:3, 2] = [0.0, 5e-7, 0.1]                 # the z ≈ 0 guards
    uj, okj = JC.project(cam, jnp.asarray(p))
    ut, okt = TC.project(_t(cam), torch.tensor(p))
    _close(ut.numpy(), uj)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 20 < okt.sum() < 200
    uv = rng.uniform(0, 160, (50, 2))
    d = rng.uniform(0.5, 30, 50)
    _close(TC.backproject(_t(cam), torch.tensor(uv), torch.tensor(d)).numpy(),
           JC.backproject(cam, jnp.asarray(uv), jnp.asarray(d)))
    c = TC.carla_camera()
    assert isinstance(c.fx, float)
    np.testing.assert_allclose(c.fx, JC.carla_camera().fx, rtol=1e-15)


def test_propagate_matches_jax():
    cfg = _cfg()
    sj = _state()
    acc, gyr, dts = _imu_window()
    pj = JE.propagate(cfg, sj, *map(jnp.asarray, (acc, gyr, dts)))
    pt = TE.propagate(_t(cfg), _t(sj), *map(torch.tensor, (acc, gyr, dts)))
    _close_state(pt, pj)


@pytest.mark.parametrize("use_depth", [True, False])
def test_update_matches_jax(use_depth):
    """Reprojection rows with noise, two invalid slots, two outlier tracks
    that the χ² gate must drop; depth rows with holes and one outlier."""
    cfg = _cfg(use_depth_update=use_depth)
    sj = _state(seed=2)
    uv, vis = JE._predict_pixels(cfg, sj)
    z = JE._predict_cam_z(cfg, sj)
    rng = np.random.default_rng(3)
    obs_uv = np.asarray(uv) + rng.normal(0, 0.7, (M, 2))
    obs_uv[1] += 40.0                             # gated pixel outliers
    obs_uv[4] -= 25.0
    obs_valid = np.ones(M)
    obs_valid[[2, 9]] = 0.0
    obs_depth = np.asarray(z) + rng.normal(0, 0.2, M)
    obs_depth[[0, 5]] = 0.0                       # no LiDAR return
    obs_depth[6] += 15.0                          # gated depth outlier
    args = (obs_uv, obs_valid, obs_depth)
    uj = JE.update(cfg, sj, *map(jnp.asarray, args))
    ut = TE.update(_t(cfg), _t(sj), *map(torch.tensor, args))
    _close_state(ut, uj)
    assert np.asarray(vis)[:8].all()
    # The update moved the state (the test is not vacuous).
    assert np.abs(np.asarray(uj.pose) - np.asarray(sj.pose)).max() > 1e-5


@pytest.mark.parametrize("static", [1.0, 0.0])
def test_gravity_and_zero_velocity_updates_match_jax(static):
    cfg = _cfg()
    sj = _state(seed=4)._replace(vel=jnp.asarray([0.02, -0.01, 0.0], DT))
    acc = np.array([0.05, -0.08, 9.79])
    gj = JE.gravity_update(cfg, sj, jnp.asarray(acc),
                           is_static=jnp.asarray(static, DT))
    gt = TE.gravity_update(_t(cfg), _t(sj), torch.tensor(acc),
                           is_static=torch.tensor(static, dtype=torch.float64))
    _close_state(gt, gj)
    zj = JE.zero_velocity_update(cfg, sj, jnp.asarray(static, DT))
    zt = TE.zero_velocity_update(_t(cfg), _t(sj),
                                 torch.tensor(static, dtype=torch.float64))
    _close_state(zt, zj)
    moved = np.abs(np.asarray(zj.vel) - np.asarray(sj.vel)).max() > 1e-4
    assert moved == (static > 0)


def test_detect_no_motion_matches_jax():
    cfg = _cfg()
    for seed, scale in ((0, 1.0), (1, 0.001)):
        acc, gyr, dts = _imu_window(seed)
        acc = (acc - [0, 0, 9.81]) * scale + [0, 0, 9.81]
        gyr = gyr * scale
        j = JE.detect_no_motion(cfg, *map(jnp.asarray, (acc, gyr, dts)))
        t = TE.detect_no_motion(_t(cfg), *map(torch.tensor, (acc, gyr, dts)))
        assert float(t) == float(j) == (1.0 if scale < 1 else 0.0)


@pytest.mark.parametrize("enable", [True, False])
def test_init_landmark_matches_jax(enable):
    cfg = _cfg()
    sj = _state(seed=5)
    uv, d = np.array([71.3, 48.9]), np.array(7.25)
    lj = JE.init_landmark(cfg, sj, jnp.asarray(3, jnp.int32),
                          jnp.asarray(uv), jnp.asarray(d),
                          jnp.asarray(0.1, DT), jnp.asarray(enable))
    lt = TE.init_landmark(_t(cfg), _t(sj), 3, torch.tensor(uv),
                          torch.tensor(d), 0.1, enable)
    _close_state(lt, lj)
    assert (np.asarray(lj.cov)[24:27, 24:27] != np.asarray(sj.cov)[24:27, 24:27]
            ).any() == enable


def test_init_landmarks_all_slots_match_the_jax_loop():
    """The port replenishes all slots at once; JAX loops over them
    (``pipeline.py:67-73``)."""
    cfg = _cfg()
    sj = _state(seed=6)
    rng = np.random.default_rng(7)
    uv = rng.uniform(10, 150, (M, 2))
    d = rng.uniform(2, 30, M)
    en = np.zeros(M, bool)
    en[[0, 3, 4, 8]] = True
    s = sj
    for i in range(M):
        s = JE.init_landmark(cfg, s, jnp.asarray(i, jnp.int32),
                             jnp.asarray(uv[i]), jnp.asarray(d[i]),
                             jnp.asarray(0.1, DT), jnp.asarray(en[i]))
    st = TE.init_landmarks(_t(cfg), _t(sj), torch.tensor(uv), torch.tensor(d),
                           0.1, torch.tensor(en))
    _close_state(st, s)


def test_covariances_match_jax():
    cfg = _cfg()
    sj = _state(seed=8)
    _close(TE.pose_covariance(_t(cfg), _t(sj)).numpy(),
           JE.pose_covariance(cfg, sj))
    _close(TE.twist_covariance(_t(cfg), _t(sj)).numpy(),
           JE.twist_covariance(cfg, sj))


def test_singular_innovation_gives_nan_not_an_exception():
    """A singular S (a gravity row with zero noise on a state whose
    attitude and accelerometer-bias rows are exactly known): JAX's solve
    returns non-finite numbers, the port's NaN, where
    ``torch.linalg.solve`` would raise."""
    cfg = _cfg(gravity_sigma=0.0)
    sj = _state(seed=9)._replace(vel=jnp.asarray([0.02, 0.0, 0.0], DT))
    cov = np.asarray(sj.cov).copy()
    for sl in (slice(0, 3), slice(9, 12)):
        cov[sl, :] = 0.0
        cov[:, sl] = 0.0
    sj = sj._replace(cov=jnp.asarray(cov))
    acc = np.array([0.0, 0.0, 9.81])
    gj = JE.gravity_update(cfg, sj, jnp.asarray(acc), jnp.asarray(1.0, DT))
    gt = TE.gravity_update(_t(cfg), _t(sj), torch.tensor(acc),
                           torch.tensor(1.0, dtype=torch.float64))
    assert not np.isfinite(np.asarray(gj.pose)).all()
    assert torch.isnan(gt.pose).all() and torch.isnan(gt.cov).any()
    assert torch.isnan(TE._solve(torch.zeros(3, 3, dtype=torch.float64),
                                 torch.ones(3, dtype=torch.float64))).all()


def _synthetic_frames(T=10):
    """10 frames of JAX synthetic tracks along the town drive."""
    cfg = _cfg()
    traj = JSC._town_traj()
    times = (np.arange(T) + 1.0) / 20.0
    poses = np.asarray(jax.vmap(traj.pose_fn)(jnp.asarray(times, DT)))
    imu_w = JS.imu_windows_for_frames(traj, times, imu_hz=200.0, dtype=DT)
    lms = JS.landmark_field(400, seed=1, extent=40.0, height=(0.5, 10.0))
    lms[:, 0] = np.random.default_rng(3).uniform(-40.0, 42.0, 400)
    return cfg, traj, times, poses, imu_w, lms


def test_synthetic_frames_match_jax():
    cfg, traj, times, poses, imu_w, lms = _synthetic_frames()
    fj = JS.make_frames(cfg, poses, imu_w, lms, seed=2)
    tw = TS.imu_windows_for_frames(TSC._town_traj(), times, imu_hz=200.0,
                                   device="cpu")
    for a, b in zip(tw, imu_w):
        _close(a.numpy(), b)
    ft = TS.make_frames(_t(cfg), poses, tw, lms, seed=2)
    for f in fj._fields:
        _close(getattr(ft, f).numpy(), getattr(fj, f))
    assert np.asarray(fj.new_enable)[0].sum() == M


def test_pipeline_run_matches_jax():
    """10 frames of synthetic tracks through ``pipeline.run``. Poses and
    velocities to 1e-9; the covariance outputs to 1e-9 of their largest
    entry: ten iterated updates carry round-off through the gain."""
    cfg, traj, times, poses, imu_w, lms = _synthetic_frames()
    fj = JS.make_frames(cfg, poses, imu_w, lms, seed=2)
    t0 = jnp.zeros((), DT)
    s0 = JE.init(cfg, traj.pose_fn(t0), traj.vel_fn(t0), jnp.zeros(6, DT))
    sj, oj = JP.run(cfg, s0, fj)
    st, ot = TP.run(_t(cfg), _t(s0), _t(fj))
    _close(ot.pose.numpy(), oj.pose)
    _close(ot.vel.numpy(), oj.vel)
    for f in ("cov", "twist_cov"):
        c = np.asarray(getattr(oj, f))
        _close(getattr(ot, f).numpy(), c, atol=1e-9 * np.abs(c).max())
    _close(st.landmarks.numpy(), sj.landmarks)
    err = np.linalg.norm(np.asarray(oj.pose)[:, 4:] - poses[:, 4:], axis=1)
    assert err.max() < 0.1


def test_pipeline_run_in_float32_stays_float32():
    """The card runs the filter in float32: every output keeps that dtype
    (a float64 Jacobian would make ``init_landmarks`` fail), and the poses
    stay within 1e-3 m / 1e-4 of the float64 run of the same frames."""
    cfg, traj, times, poses, imu_w, lms = _synthetic_frames(T=5)
    fj = JS.make_frames(cfg, poses, imu_w, lms, seed=2)
    t0 = jnp.zeros((), DT)
    s0 = JE.init(cfg, traj.pose_fn(t0), traj.vel_fn(t0), jnp.zeros(6, DT))
    f32 = lambda x: convert.to_torch(x, "cpu", torch.float32)
    s32, o32 = TP.run(_t(cfg), f32(s0), f32(fj))
    _, o64 = TP.run(_t(cfg), _t(s0), _t(fj))
    for x in (*s32, *o32):
        assert x.dtype == torch.float32
    _close(o32.pose[:, 4:].numpy(), o64.pose[:, 4:].numpy(), atol=1e-3)
    _close(o32.pose[:, :4].numpy(), o64.pose[:, :4].numpy(), atol=1e-4)


def test_convert_carries_vio_state_and_config():
    """A JAX VioConfig whose ``pose_ic`` is a tuple of numpy scalars comes
    across with Python floats (static values), and a VioState with its
    tensors."""
    cfg = _cfg()
    assert all(isinstance(x, np.generic) for x in cfg.pose_ic)
    tc = _t(cfg)
    assert type(tc) is TE.VioConfig
    assert all(type(x) is float for x in tc.pose_ic)
    assert type(tc.cam) is TC.Camera and type(tc.cam.fx) is float
    assert tc == TE.VioConfig(**{f: getattr(tc, f) for f in tc._fields})
    ts = _t(_state())
    assert type(ts) is TE.VioState
    assert ts.cov.dtype == torch.float64 and tuple(ts.cov.shape) == (45, 45)

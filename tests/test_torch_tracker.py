"""Parity of the port's image front-end (``frontends/vio/tracker``,
``frontend``), the camera renderer (``data/raycast``) and the image-driven
town build (``data/scenarios``) with the JAX package, in float64 on
identical numpy inputs at 160×120 with M = 10 slots.

Tolerance: 1e-9 absolute unless a test states otherwise. The image ops
are the same shift-and-add passes in the same tap order, the max-pool is
exact and the top-k keeps the lower index among ties, so detections match
exactly; KLT iterates on hat-matrix products whose sums may run in another
order (~1e-13 on 0-255 intensities)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import raycast as JR
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.frontends.vio import camera as JC
from vil_sensor_fusion_tpu.frontends.vio import ekf as JE
from vil_sensor_fusion_tpu.frontends.vio import frontend as JF
from vil_sensor_fusion_tpu.frontends.vio import tracker as JT
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.data import raycast as TR
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC
from vil_sensor_fusion_tpu_torch.frontends.vio import frontend as TF
from vil_sensor_fusion_tpu_torch.frontends.vio import tracker as TT

DT = jnp.float64
M = 10
ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files side by side, one
    worker each, and these tests run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _cam():
    return JC.Camera(fx=107.0, fy=107.0, cx=80.0, cy=60.0, width=160,
                     height=120)


def _fcfg(**kw):
    return JF.FrontendConfig(cam=_cam(), n_candidates=32, min_dist=10.0,
                             min_score=0.5, **kw)


def _blobs(H=120, W=160, seed=0, shift=(0.0, 0.0), n=30):
    """Smooth random blobs, optionally shifted by a sub-pixel amount."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W))
    for _ in range(n):
        cx, cy = rng.uniform(15, W - 15), rng.uniform(15, H - 15)
        s = rng.uniform(3, 7)
        a = rng.uniform(50, 255)
        img += a * np.exp(-(((xx - shift[0]) - cx) ** 2
                            + ((yy - shift[1]) - cy) ** 2) / (2 * s * s))
    return img


def test_filters_and_pyramid_match_jax():
    img = _blobs()
    gj = JT.sobel(jnp.asarray(img))
    gt = TT.sobel(torch.tensor(img))
    for a, b in zip(gt, gj):
        _close(a.numpy(), b)
    _close(TT._box(torch.tensor(img), 5).numpy(),
           JT._box(jnp.asarray(img), 5))
    _close(TT.shi_tomasi(torch.tensor(img)).numpy(),
           JT.shi_tomasi(jnp.asarray(img)))
    for a, b in zip(TT.pyramid(torch.tensor(img), 3),
                    JT.pyramid(jnp.asarray(img), 3)):
        assert a.shape == b.shape
        _close(a.numpy(), b)
    # Batched over frames, as the front-end calls them.
    stack = np.stack([img, _blobs(seed=1)])
    _close(TT.shi_tomasi(torch.tensor(stack))[1].numpy(),
           JT.shi_tomasi(jnp.asarray(stack[1])))


@pytest.mark.parametrize("n_blobs", [30, 3])
def test_detect_matches_jax(n_blobs):
    """Against JAX's exact top-k (``approx=False``) everything matches,
    the −inf padding slots too: there are fewer peaks than candidates, the
    padding scores tie, and both sides fill them with the lowest flat
    indices. JAX's default (``approx_max_k``, whose CPU fallback orders
    the tied padding otherwise) gives the same peaks and scores; padding
    is never accepted as a feature, so its pixels reach no output."""
    img = _blobs(seed=2, n=n_blobs)
    uj, sj = JT.detect(jnp.asarray(img), 32, nms_radius=8, approx=False)
    ut, st = TT.detect(torch.tensor(img), 32, nms_radius=8)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    ua, sa = JT.detect(jnp.asarray(img), 32, nms_radius=8)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sa))
    peak = np.isfinite(np.asarray(sa))
    np.testing.assert_array_equal(ut.numpy()[peak], np.asarray(ua)[peak])
    assert (~peak).sum() > (16 if n_blobs == 3 else 0)
    # Batched: each frame as alone.
    stack = torch.tensor(np.stack([_blobs(seed=3), img]))
    ub, sb = TT.detect(stack, 32, nms_radius=8)
    np.testing.assert_array_equal(ub[1].numpy(), np.asarray(uj))


def test_bilinear_matches_jax():
    img = _blobs(seed=4)
    rng = np.random.default_rng(5)
    uv = np.concatenate([rng.uniform(-3, 163, (60, 2)),
                         [[159.5, 119.7], [0.0, 0.0], [12.0, 7.0]]])
    _close(TT.bilinear(torch.tensor(img), torch.tensor(uv)).numpy(),
           JT.bilinear(jnp.asarray(img), jnp.asarray(uv)))


def test_klt_track_matches_jax():
    """A known sub-pixel shift, one track pushed beyond the per-level
    capture margin, one dead slot, and one near the border (clamped
    window)."""
    shift = (3.7, -2.3)
    img0, img1 = _blobs(seed=6), _blobs(seed=6, shift=shift)
    uv0, score = JT.detect(jnp.asarray(img0), 12, nms_radius=8)
    uv0 = np.asarray(uv0).copy()
    valid = (np.asarray(score) > 1.0).astype(np.float64)
    uv0[3] += [30.0, 0.0]          # 7.5 px off at the coarsest level
    valid[5] = 0.0
    uv0[6] = [4.0, 3.0]
    valid[6] = 1.0
    pj0, pj1 = JT.pyramid(jnp.asarray(img0), 3), JT.pyramid(jnp.asarray(img1), 3)
    uj, okj = JT.klt_track(pj0, pj1, jnp.asarray(uv0), jnp.asarray(valid))
    pt0, pt1 = TT.pyramid(torch.tensor(img0), 3), TT.pyramid(torch.tensor(img1), 3)
    ut, okt = TT.klt_track(pt0, pt1, torch.tensor(uv0), torch.tensor(valid))
    _close(ut.numpy(), uj)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj) > 0
    assert ok.sum() >= 6 and not ok[5] and not ok[6]
    flow = (np.asarray(uj) - uv0)[ok]
    assert np.median(np.linalg.norm(flow - shift, axis=1)) < 0.3


def _sweep_points(seed=7, P=400):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, P), rng.uniform(-5, 5, P),
                    rng.uniform(-2, 40, P)], 1)
    valid = (rng.uniform(size=P) > 0.1).astype(np.float64)
    return pts, valid


def test_depth_association_matches_jax():
    """Projected sweep and nearest-in-image depth, with an exact z tie
    broken by the smaller depth."""
    cfg = _fcfg()
    pts, valid = _sweep_points()
    pts[0, 2] = abs(pts[0, 2]) + 1.0
    pts[1] = pts[0] * 2.0                # the same pixel, exactly, farther
    pts[2] = pts[0] * 0.5                # and nearer: its z wins the tie
    valid[:3] = 1.0
    prj = JF.project_sweep(cfg, jnp.asarray(pts), jnp.asarray(valid))
    prt = TF.project_sweep(_t(cfg), torch.tensor(pts), torch.tensor(valid))
    _close(prt.numpy(), prj)
    rng = np.random.default_rng(8)
    uv = np.concatenate([rng.uniform(0, 160, (40, 2)),
                         np.asarray(prj)[:1, :2] + 0.3])
    dj = JF.depth_at(cfg, prj, jnp.asarray(uv))
    dt = TF.depth_at(_t(cfg), prt, torch.tensor(uv))
    _close(dt.numpy(), dj)
    assert float(dt[-1]) == pytest.approx(float(np.asarray(prj)[2, 2]))
    assert (dt.numpy() == 0).any() and (dt.numpy() > 0).sum() > 10


def test_assign_candidates_matches_jax():
    cfg = _fcfg()
    rng = np.random.default_rng(9)
    live_uv = rng.uniform(0, 160, (M, 2))
    live_valid = (rng.uniform(size=M) > 0.5).astype(np.float64)
    cand_uv = rng.uniform(0, 160, (32, 2))
    cand_uv[5] = cand_uv[4] + 2.0               # suppressed by an earlier one
    cand_score = np.sort(rng.uniform(-1, 30, 32))[::-1].copy()
    cand_depth = np.where(rng.uniform(size=32) > 0.2,
                          rng.uniform(1, 40, 32), 0.0)
    args = (live_uv, live_valid, cand_uv, cand_score, cand_depth)
    rj = JF.assign_candidates(cfg, *map(jnp.asarray, args))
    rt = TF.assign_candidates(_t(cfg), *map(torch.tensor, args))
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < float(rt[2].sum()) <= (live_valid == 0).sum()


def _rendered(n_frames=3):
    """Frames rendered by the JAX package along the town drive, the sweep
    at the first pose in the camera frame."""
    cam = _cam()
    world = JR.town_world(n_boxes=28, seed=0, dtype=DT)
    traj = JSC._town_traj()
    pose_ic = JF.forward_camera_extrinsics(DT)
    times = (np.arange(n_frames) + 1.0) / 20.0
    poses = jax.vmap(traj.pose_fn)(jnp.asarray(times, DT))
    poses_cam = jax.vmap(lambda p: JL.pose_compose(p, pose_ic))(poses)
    imgs = np.asarray(JR.render_camera_series(world, poses_cam, cam))
    sweep = JR.raycast(world, poses[0])
    pts, msk = JF.sweep_to_camera(sweep.xyz[:, ::4], sweep.mask[:, ::4],
                                  JL.pose_inverse(pose_ic))
    return world, poses_cam, imgs, np.asarray(pts), np.asarray(msk)


def test_render_camera_matches_jax():
    world, poses_cam, imgs, _, _ = _rendered(1)
    it = TR.render_camera(_t(world), torch.tensor(np.asarray(poses_cam[0])),
                          _t(_cam()))
    _close(it.numpy(), imgs[0])
    assert imgs[0].std() > 10.0                 # textured, not blank


def test_frontend_step_and_build_frames_match_jax():
    cfg = _fcfg()
    _, _, imgs, pts, msk = _rendered(3)
    ts_j = JF.init_tracker(cfg, M, DT)
    ts_t = TF.init_tracker(_t(cfg), M, torch.float64, device="cpu")
    for k in range(2):
        ts_j, oj = JF.frontend_step(cfg, ts_j, jnp.asarray(imgs[k]),
                                    jnp.asarray(pts), jnp.asarray(msk))
        ts_t, ot = TF.frontend_step(_t(cfg), ts_t, torch.tensor(imgs[k]),
                                    torch.tensor(pts), torch.tensor(msk))
        for a, b in zip(ot, oj):
            _close(a.numpy(), b)
    assert float(np.asarray(oj[1]).sum()) >= M * 0.7   # frame 1 tracks

    T = imgs.shape[0]
    rng = np.random.default_rng(10)
    imu_w = (rng.normal(size=(T, 11, 3)), rng.normal(size=(T, 11, 3)),
             np.full((T, 11), 0.005))
    pts3, msk3 = np.stack([pts] * T), np.stack([msk] * T)
    fj = JF.build_frames(cfg, jnp.asarray(imgs), jnp.asarray(pts3),
                         jnp.asarray(msk3), tuple(map(jnp.asarray, imu_w)), M)
    ft = TF.build_frames(_t(cfg), torch.tensor(imgs), torch.tensor(pts3),
                         torch.tensor(msk3), tuple(map(torch.tensor, imu_w)),
                         M)
    for f in fj._fields:
        _close(getattr(ft, f).numpy(), getattr(fj, f))


def test_image_driven_town_build_matches_jax(monkeypatch):
    """``scenarios.build(vio_from_images=True)`` over 0.5 s at 160×120: the
    port draws its town from numpy, so it is handed the JAX world; the
    rest (trajectory, IMU windows, sweeps, renders, tracker) is its own."""
    cam = _cam()
    pose_ic = JF.forward_camera_extrinsics(DT)
    vio_cfg = JE.VioConfig(num_landmarks=M, cam=cam,
                           pose_ic=tuple(np.asarray(pose_ic)))
    fcfg = _fcfg()
    sj = JSC.build("town", duration=0.5, vio_cfg=vio_cfg, dtype=DT,
                   vio_from_images=True, frontend_cfg=fcfg)
    world = _t(sj.world)
    monkeypatch.setattr(TSC.rc, "town_world", lambda **kw: world)
    st = TSC.build("town", duration=0.5, vio_cfg=_t(vio_cfg),
                   dtype=torch.float64, device="cpu", vio_from_images=True,
                   frontend_cfg=_t(fcfg))
    _close(st.images.numpy(), sj.images)
    _close(st.cam_points.numpy(), sj.cam_points)
    np.testing.assert_array_equal(st.cam_point_valid.numpy(),
                                  np.asarray(sj.cam_point_valid))
    for f in sj.vio_frames._fields:
        _close(getattr(st.vio_frames, f).numpy(), getattr(sj.vio_frames, f))
    live = np.asarray(sj.vio_frames.obs_valid)[2:].mean()
    assert live > 0.5
    np.testing.assert_array_equal(st.lidar_guess_idx, sj.lidar_guess_idx)
    # render_frontend_inputs reproduces the build's camera inputs.
    imgs, pts, msk = TSC.render_frontend_inputs(
        st, _t(cam), torch.tensor(np.asarray(pose_ic)), dtype=torch.float64)
    _close(imgs.numpy(), sj.images)
    _close(pts.numpy(), sj.cam_points)

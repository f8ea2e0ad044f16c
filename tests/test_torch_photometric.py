"""Parity of the port's direct photometric VIO (``frontends/vio/
photometric.py``, ``ekf.depth_update``) with the JAX package, in float64 on
identical numpy inputs, at ``tests/test_photometric.py``'s small rig: a
160×120 camera (fx 107), 10 landmark slots, three photometric levels,
patch radius 3, a 0.3 s town drive rendered by JAX (its images, candidates
and initial state are handed to the port).

Tolerances: patch values and gradients 1e-10 (the same hat-matrix
products in another batch layout). The update's states and covariances
1e-8: both sides compress the (M·L·P × D) stack with a reduced QR whose Q
and R are not unique where rows are masked (exact zeros), so the two QRs
differ while the update, which depends on R only up to a left orthogonal
factor, agrees to round-off; Q and R are never compared. The covariance is
compared relative to its largest entry (1e4 on fresh landmark slots). The
χ² verdicts, the patch ``ok`` flags and the live slots are held exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.frontends import vio as JV
from vil_sensor_fusion_tpu.frontends.vio import ekf as JE
from vil_sensor_fusion_tpu.frontends.vio import frontend as JF
from vil_sensor_fusion_tpu.frontends.vio import photometric as JPH
from vil_sensor_fusion_tpu.fusion import vil as JVIL
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.frontends.vio import ekf as TE
from vil_sensor_fusion_tpu_torch.frontends.vio import photometric as TPH
from vil_sensor_fusion_tpu_torch.fusion import vil as TVIL

DT = jnp.float64
ATOL = 1e-8


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


def _close_state(st, sj, atol=ATOL):
    for f in ("pose", "vel", "bias", "landmarks"):
        _close(getattr(st, f).numpy(), getattr(sj, f), atol)
    np.testing.assert_array_equal(st.lm_valid.numpy(), np.asarray(sj.lm_valid))
    cj = np.asarray(sj.cov)
    _close(st.cov.numpy(), cj, atol=atol * max(np.abs(cj).max(), 1.0))


def _texture(H=96, W=128, seed=0):
    """test_photometric.py's smooth random texture."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W))
    k = np.array([0.25, 0.5, 0.25])
    for _ in range(2):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, img)
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    return img


# Centres inside, on the ok-footprint's edges, near and past every border
# (the window corner clamps there), and far outside.
_UV = np.array([[40.3, 50.7], [60.2, 30.9], [5.0, 50.0], [5.01, 50.0],
                [2.0, 50.0], [122.0, 40.0], [121.99, 40.0], [127.4, 95.6],
                [64.0, 5.0], [64.0, 90.0], [64.0, 89.99], [-3.2, -7.5],
                [300.7, 12.2], [0.5, 0.5], [63.5, 47.5]])


@pytest.mark.parametrize("radius", [2, 3])
def test_sample_patch_grad_matches_jax(radius):
    img = _texture()
    pj = jax.vmap(lambda u: JPH._sample_patch_grad(jnp.asarray(img), u,
                                                   radius))(jnp.asarray(_UV))
    pt = TPH._sample_patch_grad(torch.as_tensor(img), torch.as_tensor(_UV),
                                radius)
    for a, b in zip(pt[:3], pj[:3]):
        _close(a.numpy(), b, 1e-10)
    np.testing.assert_array_equal(pt[3].numpy(), np.asarray(pj[3]))
    assert 0 < int(pt[3].sum()) < len(_UV)


def test_extract_templates_matches_jax():
    img = _texture(seed=2)
    cfg = JV.VioConfig(num_landmarks=len(_UV), photo_levels=3,
                       patch_radius=3)
    pyr = tuple(JV.tracker.pyramid(jnp.asarray(img), 3))
    uv = _UV * np.array([1.0, 1.0])
    tj, oj = JPH.extract_templates(cfg, pyr, jnp.asarray(uv))
    tt, ot = TPH.extract_templates(_t(cfg), _t(pyr), torch.as_tensor(uv))
    assert tt.shape == (len(_UV), 3, 49)
    _close(tt.numpy(), tj, 1e-10)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


# ---------------------------------------------------------------------------
# The rendered rig
# ---------------------------------------------------------------------------

def _rendered_rig(n_landmarks=10, duration=0.3):
    """test_photometric.py's ``_rendered_rig`` in float64."""
    cam = JV.camera.Camera(fx=107.0, fy=107.0, cx=80.0, cy=60.0,
                           width=160, height=120)
    pose_ic = JF.forward_camera_extrinsics(DT)
    vio_cfg = JV.VioConfig(
        num_landmarks=n_landmarks, update_iters=2, cam=cam,
        pose_ic=tuple(np.asarray(pose_ic)),
        use_photometric=True, patch_radius=3, photo_levels=3,
        photo_sigma=4.0)
    fcfg = JF.FrontendConfig(cam=cam, n_candidates=32, min_dist=10.0,
                             min_score=0.5)
    sc = JSC.build("town", duration=duration, vio_cfg=vio_cfg, dtype=DT,
                   vio_from_images=True, frontend_cfg=fcfg)
    return vio_cfg, fcfg, sc


@pytest.fixture(scope="module")
def rig():
    vio_cfg, fcfg, sc = _rendered_rig()
    pre = JF.precompute_frames(fcfg, sc.images.astype(DT),
                               sc.cam_points.astype(DT),
                               sc.cam_point_valid.astype(DT))
    return vio_cfg, fcfg, sc, pre


def _true_state_with_landmarks(vio_cfg, fcfg, sc, pre, t=0.0,
                               sigmas=(1e-3, 1e-3, 1e-2, 1e-2, 1e-3)):
    """test_photometric.py's state at the true pose with landmarks from the
    frame's candidates (LiDAR depth) and their captured templates, made by
    the JAX package."""
    pyrs, cand_uv, cand_score, cand_depth, _ = pre
    pyr0 = tuple(p[0] for p in pyrs)
    tq = jnp.asarray(t, DT)
    s = JV.init(vio_cfg, sc.traj.pose_fn(tq), sc.traj.vel_fn(tq),
                jnp.zeros(6, DT), sigmas=sigmas)
    M = vio_cfg.num_landmarks
    new_uv, new_depth, new_enable = JF.assign_candidates(
        fcfg, jnp.zeros((M, 2), DT), jnp.zeros((M,), DT),
        cand_uv[0], cand_score[0], cand_depth[0])
    for i in range(M):
        s = JE.init_landmark(vio_cfg, s, jnp.asarray(i, jnp.int32),
                             new_uv[i], new_depth[i],
                             jnp.asarray(0.05, DT), new_enable[i] > 0)
    tmpl, tok = JPH.extract_templates(vio_cfg, pyr0, new_uv)
    return s, tmpl, tok * new_enable[:, None], pyr0


def _perturbed(s, dtheta=0.015):
    q = JL.pose_quat(s.pose)
    dq = JL.so3_exp_quat(jnp.array([0.0, 0.0, dtheta], DT))
    return s._replace(pose=JL.pose_make(JL.quat_mul(q, dq),
                                        JL.pose_trans(s.pose)))


@pytest.mark.parametrize("case", ["at-capture", "perturbed-6-iters",
                                  "all-masked"])
def test_photometric_update_matches_jax(rig, case):
    vio_cfg, fcfg, sc, pre = rig
    sigmas = ((0.02, 1e-2, 1e-2, 1e-2, 1e-3) if case != "at-capture"
              else (1e-3, 1e-3, 1e-2, 1e-2, 1e-3))
    s, tmpl, tok, pyr0 = _true_state_with_landmarks(vio_cfg, fcfg, sc, pre,
                                                    sigmas=sigmas)
    cfg = vio_cfg
    if case != "at-capture":
        s = _perturbed(s)
        cfg = vio_cfg._replace(update_iters=6)
    if case == "all-masked":
        tok = jnp.zeros_like(tok)
    sj, cj = JPH.photometric_update(cfg, s, pyr0, tmpl, tok)
    st, ct = TPH.photometric_update(_t(cfg), _t(s), _t(pyr0), _t(tmpl),
                                    _t(tok))
    _close_state(st, sj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert np.isfinite(st.cov.numpy()).all()
    if case == "all-masked":
        # A = 0: the gain is zero, and nothing moves.
        _close_state(st, s, atol=1e-12)
    elif case == "at-capture":
        assert float(ct.sum()) >= 6                  # live patches pass
        dp = np.linalg.norm(st.pose.numpy()[4:] - np.asarray(s.pose)[4:])
        assert dp < 0.02
    else:
        assert float(ct.sum()) >= 1


def test_photometric_update_refuses_a_short_pyramid(rig):
    vio_cfg, fcfg, sc, pre = rig
    s, tmpl, tok, pyr0 = _true_state_with_landmarks(vio_cfg, fcfg, sc, pre)
    with pytest.raises(ValueError, match="photo_levels=3 exceeds"):
        TPH.photometric_update(_t(vio_cfg), _t(s), _t(pyr0[:2]), _t(tmpl),
                               _t(tok))


def test_depth_update_matches_jax(rig):
    """Rows of every kind: a live slot with depth, one without (0), one
    whose depth fails the χ² gate, and dead slots."""
    vio_cfg, fcfg, sc, pre = rig
    s, _, _, _ = _true_state_with_landmarks(vio_cfg, fcfg, sc, pre)
    z = np.asarray(JE._predict_cam_z(vio_cfg, s))
    M = vio_cfg.num_landmarks
    obs = z * (1.0 + 0.02 * np.cos(np.arange(M)))
    obs[1] = 0.0
    obs[2] = z[2] + 40.0                      # far outside the 1-dof gate
    s = s._replace(lm_valid=s.lm_valid.at[M - 1].set(0.0))
    sj = JE.depth_update(vio_cfg, s, jnp.asarray(obs))
    st = TE.depth_update(_t(vio_cfg), _t(s), torch.as_tensor(obs))
    _close_state(st, sj, 1e-9)
    assert not np.allclose(np.asarray(sj.landmarks), np.asarray(s.landmarks))


def test_depth_update_corrects_scale(rig):
    """test_photometric.py's case: a landmark straight ahead at 5 m,
    believed at 6 m; the port's update moves it to 5 m as JAX's does."""
    vio_cfg, _, sc, _ = rig
    cam = vio_cfg.cam
    t0 = jnp.zeros((), DT)
    s = JV.init(vio_cfg, sc.traj.pose_fn(t0), sc.traj.vel_fn(t0),
                jnp.zeros(6, DT))
    s = JE.init_landmark(vio_cfg, s, jnp.asarray(0, jnp.int32),
                         jnp.array([cam.cx, cam.cy], DT),
                         jnp.asarray(6.0, DT), jnp.asarray(2.0, DT),
                         jnp.asarray(True))
    obs = np.zeros(vio_cfg.num_landmarks)
    obs[0] = 5.0
    sj = JE.depth_update(vio_cfg, s, jnp.asarray(obs))
    st = TE.depth_update(_t(vio_cfg), _t(s), torch.as_tensor(obs))
    _close_state(st, sj, 1e-9)
    z1 = float(TE._predict_cam_z(_t(vio_cfg), st)[0])
    assert abs(z1 - 5.0) < 0.3, z1


def test_depth_update_in_float32_stays_float32(rig):
    vio_cfg, fcfg, sc, pre = rig
    s, _, _, _ = _true_state_with_landmarks(vio_cfg, fcfg, sc, pre)
    s32 = convert.to_torch(s, "cpu", torch.float32)
    z = TE._predict_cam_z(_t(vio_cfg), s32)
    st = TE.depth_update(_t(vio_cfg), s32, z + 0.1)
    assert all(x.dtype == torch.float32 for x in st)


# ---------------------------------------------------------------------------
# The direct pipeline
# ---------------------------------------------------------------------------

def _run_inputs(rig):
    vio_cfg, fcfg, sc, pre = rig
    t0 = jnp.zeros((), DT)
    s0 = JV.init(vio_cfg, sc.traj.pose_fn(t0), sc.traj.vel_fn(t0),
                 jnp.zeros(6, DT))
    imu_windows = (sc.vio_frames.accel, sc.vio_frames.gyro,
                   sc.vio_frames.dts)
    return JPH.init_photo(vio_cfg, s0), pre, imu_windows


def test_run_matches_jax(rig):
    """``photometric.run`` over the rig's 6 frames: every frame's outputs,
    and the final templates, validity and fail counts."""
    vio_cfg, fcfg, sc, _ = rig
    ps0, (pyrs, cu, cs, cd, projs), iw = _run_inputs(rig)
    psj, oj = jax.jit(lambda ps, py, a, b, c, pr, w: JPH.run(
        vio_cfg, fcfg, ps, py, a, b, c, pr, w))(ps0, pyrs, cu, cs, cd,
                                                projs, iw)
    pst, ot = TPH.run(_t(vio_cfg), _t(fcfg), _t(ps0), _t(pyrs), _t(cu),
                      _t(cs), _t(cd), _t(projs), _t(iw))
    assert ot.pose.shape == (6, 7)
    for f in ("pose", "vel", "cov", "twist_cov"):
        _close(getattr(ot, f).numpy(), getattr(oj, f))
    _close_state(pst.ekf, psj.ekf)
    for f in ("tmpl_ok", "fail_count"):
        np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                      np.asarray(getattr(psj, f)))
    _close(pst.templates.numpy(), psj.templates)
    assert float(pst.tmpl_ok.sum()) > 0
    assert float(pst.ekf.lm_valid.sum()) >= 0.5 * vio_cfg.num_landmarks
    assert np.isfinite(ot.cov.numpy()).all()
    err = np.abs(ot.pose.numpy()[:, 4:] - sc.gt_vio_poses[:, 4:]).max()
    assert err < 0.1


def test_convert_carries_photo_state_and_inputs(rig):
    """``convert`` carries PhotoState and PhotoInputs both ways: the
    per-level ``pyrs`` tuple and the static ``fe_cfg`` pass through."""
    vio_cfg, fcfg, sc, _ = rig
    ps0, (pyrs, cu, cs, cd, projs), iw = _run_inputs(rig)
    ps0 = ps0._replace(fail_count=ps0.fail_count.at[2].set(1.0))
    pi = JVIL.PhotoInputs(fe_cfg=fcfg, pyrs=pyrs, cand_uv=cu, cand_score=cs,
                          cand_depth=cd, projs=projs, imu_windows=iw)
    for j in (ps0, pi):
        t = _t(j)
        assert type(t).__module__.startswith("vil_sensor_fusion_tpu_torch")
        assert type(t).__name__ == type(j).__name__
        back = convert.to_numpy(t)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(j), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert type(_t(back)) is type(t)
    t = _t(pi)
    assert isinstance(t.fe_cfg, TVIL.V.FrontendConfig)
    assert t.fe_cfg == _t(fcfg)
    assert len(t.pyrs) == 3 and all(p.shape[0] == 6 for p in t.pyrs)
    assert isinstance(_t(ps0).ekf, TE.VioState)


def test_init_photo_keeps_the_state_dtype_and_device():
    cfg = TE.VioConfig(num_landmarks=4, photo_levels=2, patch_radius=2)
    s = TE.init(cfg, torch.tensor([1.0, 0, 0, 0, 0, 0, 0]), torch.zeros(3),
                torch.zeros(6))
    ps = TPH.init_photo(cfg, s)
    assert ps.templates.shape == (4, 2, 25) and ps.tmpl_ok.shape == (4, 2)
    assert all(x.dtype == torch.float32 and x.device.type == "cpu"
               for x in (ps.templates, ps.tmpl_ok, ps.fail_count))

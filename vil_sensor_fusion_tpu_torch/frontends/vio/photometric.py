"""ROVIO-style direct photometric patch updates for the VIO EKF.

Port of ``vil_sensor_fusion_tpu/frontends/vio/photometric.py``. The
reference's ROVIO (configured by gtsam_fusion/config/carla/rovio.cfg) is a
*direct* visual-inertial filter: each landmark carries a multi-level image
patch template, and the iterated EKF update minimizes the raw intensity
difference between that template and the current image at the landmark's
predicted projection; there is no separate feature-tracking measurement
(rovio.cfg patchSize/nLevels/startLevel/endLevel; the Update block's
UpdateNoise.pix is the per-pixel intensity noise).

- Patch sampling is the tracker's windowed hat-matrix form, for all
  landmarks of a level at once: one clamped window per landmark cut by one
  indexing op, then bilinear patch values and ±0.5 px central-difference
  intensity gradients as small batched matmuls (``tracker._hat_mat``).
- The measurement stack has M landmarks × L levels × P pixels rows, so the
  iterated update runs in QR-compressed square-root form: whiten and mask
  the rows, one reduced QR turns the (M·L·P × D) Jacobian into a (D × D)
  equivalent measurement, and the S-form / Joseph update proceeds at state
  dimension.
- A per-landmark χ² gate over the patch rows stands in for ROVIO's
  Mahalanobis outlier rejection (MahalanobisTh0) at patch granularity.

Differences from the JAX functions, none of them in the numbers:

- :func:`_sample_patch_grad` takes (N, 2) centres and returns (N, ·)
  where JAX's takes one centre and is ``vmap``-ed.
- ``step``'s loop over slots is ``ekf.init_landmarks``, all slots at once
  (each slot touches only its own rows); ``run``'s scan is a loop over
  frames.
- Masked rows are exactly zero, so Q and R of the QR are not unique (signs,
  and the null directions when fewer than D rows are live): the update
  depends on R only up to a left orthogonal factor, so the state and the
  covariance agree with JAX's where Q and R need not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from . import ekf as E
from . import frontend as F
from . import tracker as T
from .pipeline import VioOutput


# ---------------------------------------------------------------------------
# Patch sampling (value + gradient)
# ---------------------------------------------------------------------------

def _sample_patch_grad(
    img: torch.Tensor,          # (H, W) one pyramid level
    uv: torch.Tensor,           # (N, 2) centres in THIS level's pixel scale
    radius: int,
    margin: int = 2,
):
    """Bilinear patches + intensity gradients at each centre of ``uv``.

    Returns (patch (N, P), gx (N, P), gy (N, P), ok (N,)) with
    P = (2·radius+1)²; ``ok`` is False where the patch would leave the
    image."""
    dtype, device = uv.dtype, uv.device
    H, W = img.shape
    r = radius
    win = 2 * (r + margin) + 1
    n = uv.shape[0]
    c = torch.round(uv).long() - (r + margin)
    cx = torch.clamp(c[:, 0], 0, max(W - win, 0))
    cy = torch.clamp(c[:, 1], 0, max(H - win, 0))
    span = torch.arange(win, device=device)
    Wimg = img[(cy[:, None] + span)[:, :, None],
               (cx[:, None] + span)[:, None, :]]             # (N, win, win)
    lp = uv - torch.stack([cx, cy], dim=-1).to(dtype)
    offs = torch.arange(-r, r + 1, dtype=dtype, device=device)
    eps = 0.5
    Au0 = T._hat_mat(lp[:, 0], offs, win)
    Av0 = T._hat_mat(lp[:, 1], offs, win)
    Au_d = T._hat_mat(lp[:, 0] + eps, offs, win) - T._hat_mat(
        lp[:, 0] - eps, offs, win)
    Av_d = T._hat_mat(lp[:, 1] + eps, offs, win) - T._hat_mat(
        lp[:, 1] - eps, offs, win)
    AW = Av0 @ Wimg
    patch = (AW @ Au0.mT).reshape(n, -1)
    gx = (AW @ Au_d.mT).reshape(n, -1) / (2 * eps)
    gy = (Av_d @ Wimg @ Au0.mT).reshape(n, -1) / (2 * eps)
    # The hat matrices interpolate correctly only while every sample point
    # lies inside the (clamped) window: require the full footprint inside
    # the image with one spare pixel for the ±0.5 gradient probes.
    lo = r + margin
    ok = ((uv[:, 0] > lo) & (uv[:, 0] < W - 1 - lo)
          & (uv[:, 1] > lo) & (uv[:, 1] < H - 1 - lo))
    return patch, gx, gy, ok


def patch_dim(cfg: E.VioConfig) -> int:
    return (2 * cfg.patch_radius + 1) ** 2


def extract_templates(
    cfg: E.VioConfig,
    pyr: tuple,                 # L × (H_l, W_l)
    uv: torch.Tensor,           # (M, 2) full-resolution pixels
) -> tuple[torch.Tensor, torch.Tensor]:
    """Capture each landmark's multi-level template at ``uv``.

    Returns (templates (M, L, P), ok (M, L))."""
    tmpl, oks = [], []
    for lvl in range(cfg.photo_levels):
        p, _, _, ok = _sample_patch_grad(pyr[lvl], uv / 2.0 ** lvl,
                                         cfg.patch_radius)
        tmpl.append(p)
        oks.append(ok)
    return (torch.stack(tmpl, dim=1),
            torch.stack(oks, dim=1).to(uv.dtype))


# ---------------------------------------------------------------------------
# The direct photometric iterated EKF update
# ---------------------------------------------------------------------------

def photometric_update(
    cfg: E.VioConfig,
    s: E.VioState,
    pyr: tuple,                 # current frame's pyramid, L+ levels
    templates: torch.Tensor,    # (M, L, P)
    tmpl_ok: torch.Tensor,      # (M, L)
) -> tuple[E.VioState, torch.Tensor]:
    """Iterated EKF update from direct multi-level patch intensity errors.

    Returns ``(state, chi2_ok (M,))``: the per-landmark χ² gate verdict of
    the final iteration, so the pipeline can retire landmarks whose patch
    keeps failing the gate.

    Measurement model per landmark j, level l, patch pixel i:
        z = template[j,l,i],  h(x) = I_l(π(x, l_j)/2^l + off_i)
    linearized through the image gradient and the projection Jacobian.
    Rows are whitened by ``photo_sigma``, masked rows get zero weight, and
    one reduced QR compresses the stack to a (D × D) equivalent measurement
    before the S-form solve; the Bell–Cathey IEKF step and the final Joseph
    covariance then run as in ``ekf.update``."""
    dtype, device = s.pose.dtype, s.pose.device
    M = cfg.num_landmarks
    D = s.cov.shape[0]
    L = cfg.photo_levels
    if len(pyr) < L:
        raise ValueError(
            f"photo_levels={L} exceeds the provided pyramid depth "
            f"{len(pyr)}; set VioConfig.photo_levels <= "
            f"FrontendConfig.pyramid_levels")
    P = patch_dim(cfg)
    sig = cfg.photo_sigma
    s0 = s
    eye = torch.eye(D, dtype=dtype, device=device)

    def uv_of(dx):
        uv, _ = E._predict_pixels(cfg, E._retract(cfg, s0, dx))
        return uv.reshape(-1)

    def measurement(s_i):
        """(Rt, Qᵀb, Qᵀ(A·dx_i), chi2_ok) at linearization point s_i."""
        dx_i = E._boxminus(cfg, s_i, s0)
        J_uv, uv_pred = jacfwd(E._with_value(uv_of), has_aux=True)(dx_i)
        J_uv = J_uv.reshape(M, 2, D)
        uv_pred = uv_pred.reshape(M, 2)
        _, vis = E._predict_pixels(cfg, s_i)

        rs, Hs, ws = [], [], []
        for lvl in range(L):
            scale = 2.0 ** lvl
            patch, gx, gy, ok = _sample_patch_grad(
                pyr[lvl], uv_pred / scale, cfg.patch_radius)
            rs.append(templates[:, lvl, :] - patch)               # (M, P)
            g = torch.stack([gx, gy], dim=-1) / scale             # (M, P, 2)
            Hs.append(g @ J_uv)                                   # (M, P, D)
            ws.append(s.lm_valid * vis.to(dtype) * ok.to(dtype)
                      * tmpl_ok[:, lvl])                          # (M,)
        r = torch.stack(rs, dim=1).reshape(-1)                    # (M·L·P,)
        H = torch.stack(Hs, dim=1).reshape(-1, D)
        w = torch.stack(ws, dim=1)[:, :, None].expand(M, L, P).reshape(-1)

        # Per-landmark χ² gate over the patch rows: normalized squared
        # residual per live row.
        S_diag = ((H @ s0.cov) * H).sum(-1) + sig ** 2
        w_m = w.reshape(M, -1)
        chi2 = (r * r / S_diag * w).reshape(M, -1).sum(-1)
        dof = torch.clamp(w_m.sum(-1), min=1.0)
        chi2_ok = (chi2 / dof < cfg.photo_chi2_per_dof).to(dtype)
        w = (w_m * chi2_ok[:, None]).reshape(-1)

        # Whiten + mask, compress with one reduced QR: A = Q·Rt, so the
        # (rows × D) system becomes the D-row system (Rt, Qᵀb, I).
        A = H * (w / sig)[:, None]
        b = r * (w / sig)
        Q, Rt = torch.linalg.qr(A, mode="reduced")
        return Rt, Q.mT @ b, Q.mT @ (A @ dx_i), chi2_ok

    def gain(Rt):
        RP = Rt @ s0.cov
        return E._solve(RP @ Rt.mT + eye, RP).mT

    s_new = s
    for _ in range(cfg.update_iters):
        Rt, c, Adx, _ = measurement(s_new)
        s_new = E._retract(cfg, s0, gain(Rt) @ (c + Adx))

    Rt, _, _, chi2_ok = measurement(s_new)
    K = gain(Rt)
    cov = E._joseph(s0.cov, Rt, K, torch.ones(D, dtype=dtype, device=device))
    return s_new._replace(cov=cov), chi2_ok


# ---------------------------------------------------------------------------
# Direct pipeline: propagate → photometric update → depth anchor → replenish
# ---------------------------------------------------------------------------

class PhotoState(NamedTuple):
    """EKF state + per-landmark multi-level patch templates."""
    ekf: E.VioState
    templates: torch.Tensor    # (M, L, P)
    tmpl_ok: torch.Tensor      # (M, L)
    # Consecutive χ²-gate failures per landmark. Templates are never
    # refreshed, so a landmark whose patch keeps failing the gate
    # (occlusion, appearance change) gives no information but would hold
    # its slot forever; after PHOTO_MAX_FAIL failures in a row the slot is
    # retired so assign_candidates can refill it (ROVIO's tracking-quality
    # feature retirement).
    fail_count: torch.Tensor   # (M,)


PHOTO_MAX_FAIL = 3


def init_photo(cfg: E.VioConfig, s: E.VioState) -> PhotoState:
    """A PhotoState with no template, on the device of ``s``."""
    M, L, P = cfg.num_landmarks, cfg.photo_levels, patch_dim(cfg)
    kw = dict(dtype=s.pose.dtype, device=s.pose.device)
    return PhotoState(ekf=s,
                      templates=torch.zeros((M, L, P), **kw),
                      tmpl_ok=torch.zeros((M, L), **kw),
                      fail_count=torch.zeros((M,), **kw))


def step(
    cfg: E.VioConfig,
    fcfg: F.FrontendConfig,
    ps: PhotoState,
    pyr: tuple,                 # this frame's pyramid (L+ levels)
    cand_uv: torch.Tensor,      # (C, 2) detection candidates
    cand_score: torch.Tensor,   # (C,)
    cand_depth: torch.Tensor,   # (C,)
    proj: torch.Tensor,         # (P_pts, 3) frontend.project_sweep output
    accel: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
    depth_sigma: float = 0.1,
) -> tuple[PhotoState, VioOutput]:
    """One frame of the direct pipeline, ROVIO's loop shape: there is no
    separate tracking stage; the photometric update IS the tracker. LiDAR
    depth at the predicted pixels then anchors scale (useDepthFromLiDAR),
    and freed slots are refilled from the detection candidates with fresh
    templates."""
    dtype = ps.ekf.pose.dtype
    s = E.propagate(cfg, ps.ekf, accel, gyro, dts)
    if cfg.use_gravity_update or cfg.use_zero_velocity_update:
        static = E.detect_no_motion(cfg, accel, gyro, dts)
    if cfg.use_gravity_update:
        live = (dts > 0).to(dtype)
        n = torch.clamp(torch.sum(live), min=1.0)
        accel_mean = torch.sum(accel * live[:, None], dim=0) / n
        s = E.gravity_update(cfg, s, accel_mean, is_static=static)
    if cfg.use_zero_velocity_update:
        s = E.zero_velocity_update(cfg, s, static)

    s, chi2_ok = photometric_update(cfg, s, pyr, ps.templates, ps.tmpl_ok)

    # Landmark death: the projection left the image (ROVIO drops features
    # at the border), or the patch failed the χ² gate PHOTO_MAX_FAIL frames
    # in a row; the covariance keeps the slot's block until re-init.
    uv_pred, vis = E._predict_pixels(cfg, s)
    fail_count = torch.where((chi2_ok > 0) | (s.lm_valid <= 0), 0.0,
                             ps.fail_count + 1.0)
    alive = (fail_count < PHOTO_MAX_FAIL).to(dtype)
    s = s._replace(lm_valid=s.lm_valid * vis.to(dtype) * alive)

    if cfg.use_depth_update:
        d = F.depth_at(fcfg, proj, uv_pred) * s.lm_valid
        s = E.depth_update(cfg, s, d)
        uv_pred, _ = E._predict_pixels(cfg, s)

    # Replenish freed slots + capture their templates.
    new_uv, new_depth, new_enable = F.assign_candidates(
        fcfg, uv_pred, s.lm_valid, cand_uv, cand_score, cand_depth)
    enable = new_enable > 0
    s = E.init_landmarks(cfg, s, new_uv, new_depth, depth_sigma, enable)

    tmpl_new, tok_new = extract_templates(cfg, pyr, new_uv)
    templates = torch.where(enable[:, None, None], tmpl_new, ps.templates)
    tmpl_ok = torch.where(enable[:, None], tok_new, ps.tmpl_ok)
    fail_count = torch.where(enable, 0.0, fail_count)

    out = VioOutput(pose=s.pose, vel=s.vel,
                    cov=E.pose_covariance(cfg, s),
                    twist_cov=E.twist_covariance(cfg, s))
    return PhotoState(ekf=s, templates=templates, tmpl_ok=tmpl_ok,
                      fail_count=fail_count), out


def run(
    cfg: E.VioConfig,
    fcfg: F.FrontendConfig,
    ps0: PhotoState,
    pyrs: tuple,                # L × (T, H_l, W_l) batched pyramids
    cand_uv: torch.Tensor,      # (T, C, 2)
    cand_score: torch.Tensor,   # (T, C)
    cand_depth: torch.Tensor,   # (T, C)
    projs: torch.Tensor,        # (T, P_pts, 3)
    imu_windows: tuple,         # (accel (T,N,3), gyro (T,N,3), dts (T,N))
    depth_sigma: float = 0.1,
) -> tuple[PhotoState, VioOutput]:
    """Step the direct pipeline over a frame stream (the photometric
    counterpart of ``pipeline.run``; feed it ``frontend.precompute_frames``'
    batched candidates and pyramids), on the device the inputs are on;
    outputs stacked (T, ·)."""
    accel, gyro, dts = imu_windows
    ps, outs = ps0, []
    for t in range(cand_uv.shape[0]):
        ps, out = step(cfg, fcfg, ps, tuple(p[t] for p in pyrs), cand_uv[t],
                       cand_score[t], cand_depth[t], projs[t], accel[t],
                       gyro[t], dts[t], depth_sigma)
        outs.append(out)
    return ps, VioOutput(*(torch.stack(f) for f in zip(*outs)))

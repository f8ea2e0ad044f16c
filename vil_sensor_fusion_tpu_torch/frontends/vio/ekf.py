"""Visual-inertial error-state EKF (the ROVIO-equivalent filter).

Port of the geometric path of ``vil_sensor_fusion_tpu/frontends/vio/ekf.py``:
IMU-propagated error-state EKF with landmarks in the state, iterated
reprojection updates with LiDAR depth rows, gravity and zero-velocity
pseudo-measurements, LiDAR-depth landmark initialisation, and the
standalone camera-axis depth rows of the direct photometric mode
(``depth_update``; the photometric update itself is ``photometric.py``).

State: pose (q wxyz, p), vel, bias (ba, bg), M landmark world points.
Error order: [δθ(3) | δp(3) | δv(3) | δba(3) | δbg(3) | δl₁(3) … δl_M(3)],
right perturbation on rotation (R ≈ R̂·Exp(δθ)).

Differences from the JAX functions, none of them in the numbers:

- ``jnp.linalg.solve`` returns inf/NaN for a singular system where
  ``torch.linalg.solve`` raises; :func:`_solve` uses ``solve_ex`` and fills
  NaN, so a singular S poisons the state as it does in JAX.
- ``propagate``'s scan is a loop over the window's samples; everything that
  does not depend on the carried state (the increments, Jacobians, the
  transition and noise matrices) is computed for all samples at once, and
  the quaternion step ``q ⊗ Δq`` is a 4×4 product.
- ``pipeline.step``'s loop over slots is :func:`init_landmarks`, all slots
  at once: each slot touches only its own rows, so the result is the same.
  Its backprojection Jacobian is in closed form where JAX takes ``jacfwd``.
- Constant tensors made from a config (``pose_ic``, gravity) are made once
  per dtype and device by ``_consts.const``, so no step copies from the
  host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..._consts import const
from ...core import lie
from . import camera as C

IMU_DIM = 15


class VioConfig(NamedTuple):
    num_landmarks: int = 32
    # Continuous-time noise densities (fusion_params.yaml:24-29).
    cov_accel: float = 1e-3
    cov_gyro: float = 1e-5
    cov_bias_acc: float = 1e-6
    cov_bias_omega: float = 1e-8
    gravity: float = 9.81
    pixel_sigma: float = 1.0
    update_iters: int = 2            # iterated EKF passes (ROVIO-style)
    chi2_gate: float = 9.21          # 2-dof 99% gate per feature
    # Per-frame LiDAR depth rows at tracked features (useDepthFromLiDAR).
    use_depth_update: bool = True
    depth_sigma_update: float = 0.5  # per-measurement σ (m)
    depth_chi2_gate: float = 6.63    # 1-dof 99% gate
    # Stationary-only roll/pitch anchor from the window-mean accelerometer.
    use_gravity_update: bool = True
    gravity_sigma: float = 0.3       # m/s² measurement σ
    gravity_accel_gate: float = 0.4  # |‖f‖ − g| beyond this ⇒ skip
    # Zero-velocity update (ROVIO's ZeroVelocityUpdate block).
    use_zero_velocity_update: bool = True
    zuv_sigma: float = 0.1           # m/s measurement σ
    zuv_gyro_th: float = 0.02        # rad/s max mean |ω| for "no motion"
    zuv_accel_th: float = 0.15       # m/s² max std of ‖accel‖ for "no motion"
    zuv_chi2_gate: float = 7.69      # Mahalanobis gate (MahalanobisTh0)
    # Direct photometric mode (photometric.py; rovio.cfg patchSize/nLevels/
    # UpdateNoise.pix).
    use_photometric: bool = False
    patch_radius: int = 3
    photo_levels: int = 2
    photo_sigma: float = 4.0
    photo_chi2_per_dof: float = 4.0
    cam: C.Camera = C.carla_camera()
    # camera-from-imu extrinsics (identity: camera at the IMU, z forward)
    pose_ic: tuple = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


class VioState(NamedTuple):
    pose: torch.Tensor       # (7,) world_T_imu
    vel: torch.Tensor        # (3,)
    bias: torch.Tensor       # (6,) (ba, bg)
    landmarks: torch.Tensor  # (M, 3) world points
    lm_valid: torch.Tensor   # (M,) 0/1
    cov: torch.Tensor        # (D, D), D = 15 + 3M


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A⁻¹B, NaN where A is singular (``jnp.linalg.solve`` gives inf/NaN
    there; ``torch.linalg.solve`` would raise)."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where(info == 0, X, torch.nan)


def init(
    cfg: VioConfig,
    pose0: torch.Tensor,
    vel0: torch.Tensor,
    bias0: torch.Tensor,
    sigmas: tuple = (1e-3, 1e-3, 1e-2, 1e-2, 1e-3),
) -> VioState:
    """sigmas: (rot, pos, vel, ba, bg) initial standard deviations."""
    dtype, device = pose0.dtype, pose0.device
    M = cfg.num_landmarks
    sr, sp, sv, sba, sbg = sigmas
    diag = torch.tensor([sr ** 2] * 3 + [sp ** 2] * 3 + [sv ** 2] * 3
                        + [sba ** 2] * 3 + [sbg ** 2] * 3 + [1e4] * (3 * M),
                        dtype=dtype, device=device)
    return VioState(
        pose=pose0, vel=vel0, bias=bias0,
        landmarks=torch.zeros((M, 3), dtype=dtype, device=device),
        lm_valid=torch.zeros((M,), dtype=dtype, device=device),
        cov=torch.diag(diag),
    )


# ---------------------------------------------------------------------------
# IMU propagation
# ---------------------------------------------------------------------------

def _quat_right_mat(p: torch.Tensor) -> torch.Tensor:
    """(…, 4) → (…, 4, 4) matrix Mp with q ⊗ p = Mp @ q."""
    w, x, y, z = p.unbind(-1)
    m = torch.stack([w, -x, -y, -z,
                     x, w, z, -y,
                     y, -z, w, x,
                     z, y, -x, w], dim=-1)
    return m.reshape(p.shape[:-1] + (4, 4))


def propagate(
    cfg: VioConfig,
    s: VioState,
    accel: torch.Tensor,     # (N, 3)
    gyro: torch.Tensor,      # (N, 3)
    dts: torch.Tensor,       # (N,) (0 ⇒ masked sample)
) -> VioState:
    """Error-state EKF propagation over an IMU window.

    Landmarks are static: only the 15 IMU rows of the covariance move
    (P_II ← F P_II Fᵀ + Q; P_IL ← F P_IL). A masked sample keeps the old
    value through ``live·new + (1 − live)·old``, so a NaN spreads as in
    JAX."""
    dtype, device = s.pose.dtype, s.pose.device
    N = accel.shape[0]
    live = (dts > 0).to(dtype)
    dead = 1.0 - live
    dt = torch.clamp(dts, min=1e-12)
    ba, bg = s.bias[:3], s.bias[3:6]
    a_c = accel - ba
    w_c = gyro - bg
    theta = w_c * dt[:, None]

    # Attitude: the one part of the mean the rest depends on.
    dq = _quat_right_mat(lie.so3_exp_quat(theta))           # (N, 4, 4)
    q = lie.pose_quat(s.pose)
    q_start = []
    for k in range(N):
        q_start.append(q)
        q_new = dq[k] @ q
        q = lie.quat_normalize(live[k] * q_new + dead[k] * q)
    R = lie.quat_to_rot(torch.stack(q_start))               # (N, 3, 3)
    g_w = const((0.0, 0.0, -float(cfg.gravity)), dtype, device)
    a_w = (R @ a_c[..., None])[..., 0] + g_w                 # (N, 3)

    # Transition F and noise Q of every sample.
    dRk = lie.so3_exp(theta)
    Jr = lie.so3_right_jacobian(theta)
    Ra = R @ lie.hat(a_c)
    d1 = dt[:, None, None]
    I3 = torch.eye(3, dtype=dtype, device=device).expand(N, 3, 3)
    Z3 = torch.zeros((N, 3, 3), dtype=dtype, device=device)
    # F and G are built block by block with ``cat`` (the values JAX's
    # ``.at[].set`` writes), so they carry a lane axis under vmap.
    F = torch.cat([
        torch.cat([dRk.mT, Z3, Z3, Z3, -Jr * d1], -1),
        torch.cat([-0.5 * Ra * d1 * d1, I3, I3 * d1, -0.5 * R * d1 * d1, Z3],
                  -1),
        torch.cat([-Ra * d1, Z3, I3, -R * d1, Z3], -1),
        torch.cat([torch.zeros((N, 6, 9), dtype=dtype, device=device),
                   torch.eye(6, dtype=dtype, device=device).expand(N, 6, 6)],
                  -1),
    ], -2)
    G = torch.cat([
        torch.cat([Jr * d1, Z3], -1),
        torch.cat([Z3, 0.5 * R * d1 * d1], -1),
        torch.cat([Z3, R * d1], -1),
        torch.zeros((N, 6, 6), dtype=dtype, device=device),
    ], -2)
    q_g = (cfg.cov_gyro / dt)[:, None].expand(N, 3)
    q_a = (cfg.cov_accel / dt)[:, None].expand(N, 3)
    Q = G @ torch.diag_embed(torch.cat([q_g, q_a], 1)) @ G.mT
    zeros9 = torch.zeros((N, 9), dtype=dtype, device=device)
    q_bias = torch.cat([zeros9, (cfg.cov_bias_acc * dt)[:, None].expand(N, 3),
                        (cfg.cov_bias_omega * dt)[:, None].expand(N, 3)], 1)
    Q = Q + torch.diag_embed(q_bias)
    dp = 0.5 * a_w * d1[..., 0] * d1[..., 0]
    dv = a_w * d1[..., 0]

    # Position, velocity and the IMU rows [P_II | P_IL] of the covariance.
    p = lie.pose_trans(s.pose)
    v = s.vel
    P_I = s.cov[:IMU_DIM]
    for k in range(N):
        p_new = p + v * dt[k] + dp[k]
        v_new = v + dv[k]
        FP = F[k] @ P_I
        P_new = torch.cat([FP[:, :IMU_DIM] @ F[k].mT + Q[k],
                           FP[:, IMU_DIM:]], 1)
        p = live[k] * p_new + dead[k] * p
        v = live[k] * v_new + dead[k] * v
        P_I = live[k] * P_new + dead[k] * P_I

    cov = torch.cat([P_I, torch.cat([P_I[:, IMU_DIM:].mT,
                                     s.cov[IMU_DIM:, IMU_DIM:]], 1)], 0)
    return s._replace(pose=lie.pose_make(q, p), vel=v, cov=cov)


# ---------------------------------------------------------------------------
# Camera update
# ---------------------------------------------------------------------------

def _retract(cfg: VioConfig, s: VioState, dx: torch.Tensor) -> VioState:
    q = lie.quat_mul(lie.pose_quat(s.pose), lie.so3_exp_quat(dx[0:3]))
    p = lie.pose_trans(s.pose) + dx[3:6]
    M = cfg.num_landmarks
    return s._replace(
        pose=lie.pose_make(lie.quat_normalize(q), p),
        vel=s.vel + dx[6:9],
        bias=s.bias + dx[9:15],
        landmarks=s.landmarks + dx[IMU_DIM:].reshape(M, 3),
    )


def _landmarks_in_camera(cfg: VioConfig, s: VioState) -> torch.Tensor:
    """(M, 3) landmarks in the camera frame."""
    pose_ic = const(tuple(map(float, cfg.pose_ic)), s.pose.dtype,
                    s.pose.device)
    pose_wc = lie.pose_compose(s.pose, pose_ic)
    return lie.quat_rotate(
        lie.quat_conjugate(lie.pose_quat(pose_wc))[None],
        s.landmarks - lie.pose_trans(pose_wc)[None])


def _predict_pixels(cfg: VioConfig, s: VioState):
    """Project all landmarks into the camera: (M, 2) pixels + visibility."""
    return C.project(cfg.cam, _landmarks_in_camera(cfg, s))


def _predict_cam_z(cfg: VioConfig, s: VioState) -> torch.Tensor:
    """Per-landmark depth along the camera optical axis (M,)."""
    return _landmarks_in_camera(cfg, s)[..., 2]


def _with_value(fn):
    """fn -> fn returning (value, value), for jacfwd's ``has_aux``."""
    def f(*args):
        r = fn(*args)
        return r, r
    return f


def _joseph(cov: torch.Tensor, H: torch.Tensor, K: torch.Tensor,
            R_eff: torch.Tensor) -> torch.Tensor:
    """(I − KH) P (I − KH)ᵀ + K diag(R) Kᵀ, symmetrised."""
    D = cov.shape[0]
    I_KH = torch.eye(D, dtype=cov.dtype, device=cov.device) - K @ H
    out = I_KH @ cov @ I_KH.mT + (K * R_eff) @ K.mT
    return 0.5 * (out + out.mT)


def update(
    cfg: VioConfig,
    s: VioState,
    obs_uv: torch.Tensor,     # (M, 2) measured pixels per landmark slot
    obs_valid: torch.Tensor,  # (M,) 0/1
    obs_depth: torch.Tensor | None = None,   # (M,) LiDAR depth, 0 = none
) -> VioState:
    """Iterated EKF update from tracked-feature observations, plus (when
    ``obs_depth`` is given and cfg.use_depth_update) per-feature LiDAR
    range rows along the camera axis.

    Masked features get effectively infinite measurement variance (1e12);
    χ² gates drop outlier tracks and depths."""
    dtype, device = s.pose.dtype, s.pose.device
    M = cfg.num_landmarks
    R_pix = cfg.pixel_sigma ** 2
    R_dep = cfg.depth_sigma_update ** 2
    use_d = cfg.use_depth_update and obs_depth is not None
    s0 = s
    R_rows = torch.full((2 * M,), R_pix, dtype=dtype, device=device)
    if use_d:
        R_rows = torch.cat([R_rows, torch.full((M,), R_dep, dtype=dtype,
                                               device=device)])

    def h_of(dx):
        p_cam = _landmarks_in_camera(cfg, _retract(cfg, s0, dx))
        uv, _ = C.project(cfg.cam, p_cam)
        if use_d:
            return torch.cat([uv.reshape(-1), p_cam[..., 2]])
        return uv.reshape(-1)

    def measurement(s_i):
        """(r, H, HP, R_eff, dx_i) at linearization point s_i."""
        dx_i = _boxminus(cfg, s_i, s0)
        H, pred = jacfwd(_with_value(h_of), has_aux=True)(dx_i)
        r_uv = (obs_uv - pred[:2 * M].reshape(M, 2)).reshape(-1)

        _, vis = _predict_pixels(cfg, s_i)
        w = obs_valid * s.lm_valid * vis.to(dtype)

        HP = H @ s0.cov
        S_diag = (HP * H).sum(-1)
        r2 = r_uv * r_uv
        chi2 = (r2[0::2] / (S_diag[0:2 * M:2] + R_pix)
                + r2[1::2] / (S_diag[1:2 * M:2] + R_pix))
        w_pix = w * (chi2 < cfg.chi2_gate).to(dtype)
        w_rows = torch.repeat_interleave(w_pix, 2)
        r = r_uv
        if use_d:
            r_d = obs_depth - pred[2 * M:]
            chi2_d = r_d * r_d / (S_diag[2 * M:] + R_dep)
            w_d = (w_pix * (obs_depth > 0)
                   * (chi2_d < cfg.depth_chi2_gate).to(dtype))
            r = torch.cat([r_uv, r_d])
            w_rows = torch.cat([w_rows, w_d])
        R_eff = torch.where(w_rows > 0, R_rows, 1e12)
        return r, H, HP, R_eff, dx_i

    s_new = s
    for _ in range(cfg.update_iters):
        r, H, HP, R_eff, dx_i = measurement(s_new)
        S = HP @ H.mT + torch.diag(R_eff)
        K = _solve(S, HP).mT
        # IEKF (Bell–Cathey): dx* = K (r + H·dx_i), linearized at the
        # current iterate.
        s_new = _retract(cfg, s0, K @ (r + H @ dx_i))

    # Covariance update (Joseph) at the final linearization point.
    r, H, HP, R_eff, _ = measurement(s_new)
    S = HP @ H.mT + torch.diag(R_eff)
    K = _solve(S, HP).mT
    return s_new._replace(cov=_joseph(s0.cov, H, K, R_eff))


def _gated_update(cfg: VioConfig, s: VioState, H: torch.Tensor,
                  r: torch.Tensor, R_eff: torch.Tensor) -> VioState:
    """One linear EKF update with measurement rows H, residual r."""
    HP = H @ s.cov
    S = HP @ H.mT + torch.diag(R_eff)
    K = _solve(S, HP).mT
    s_new = _retract(cfg, s, K @ r)
    return s_new._replace(cov=_joseph(s.cov, H, K, R_eff))


def depth_update(
    cfg: VioConfig,
    s: VioState,
    obs_depth: torch.Tensor,    # (M,) LiDAR depth at the PREDICTED pixels
) -> VioState:
    """Standalone per-landmark LiDAR range update (camera-axis depth): the
    continuous useDepthFromLiDAR scale anchor of the photometric pipeline,
    where there is no tracked pixel to fuse the rows with (the geometric
    path fuses them inside :func:`update`). z = depth, h(x) = camera-frame
    z of the landmark; each row is χ²-gated, and masked rows (dead slot,
    out of view, no depth, gate failed) get variance 1e12."""
    dtype = s.pose.dtype
    R_dep = cfg.depth_sigma_update ** 2
    s0 = s

    def h_of(dx):
        return _predict_cam_z(cfg, _retract(cfg, s0, dx))

    dx0 = torch.zeros((s.cov.shape[0],), dtype=dtype, device=s.pose.device)
    H, pred = jacfwd(_with_value(h_of), has_aux=True)(dx0)     # (M, D)
    _, vis = _predict_pixels(cfg, s0)
    r = obs_depth - pred
    S_diag = ((H @ s0.cov) * H).sum(-1)
    chi2 = r * r / (S_diag + R_dep)
    w = (s.lm_valid * vis.to(dtype) * (obs_depth > 0)
         * (chi2 < cfg.depth_chi2_gate).to(dtype))
    R_eff = torch.where(w > 0, torch.full_like(r, R_dep), 1e12)
    return _gated_update(cfg, s0, H, r, R_eff)


def gravity_update(
    cfg: VioConfig,
    s: VioState,
    accel_mean: torch.Tensor,            # (3,) window-mean accelerometer
    is_static: torch.Tensor | float = 1.0,   # no-motion detector verdict
) -> VioState:
    """Accelerometer-referenced roll/pitch pseudo-measurement, STATIONARY
    only: z = accel_mean, h(x) = b_a + g·Rᵀe_z. Applied only when the
    no-motion detector fires, ‖accel_mean − b_a‖ is within
    ``gravity_accel_gate`` of g, and the filter's velocity passes its own
    Mahalanobis check; otherwise the rows get variance 1e12."""
    dtype, device = s.pose.dtype, s.pose.device
    D = s.cov.shape[0]
    e_z = const((0.0, 0.0, 1.0), dtype, device)
    R = lie.quat_to_rot(lie.pose_quat(s.pose))
    u = R.mT @ e_z                             # gravity direction in body
    ba = s.bias[:3]
    r = accel_mean - (ba + cfg.gravity * u)

    f_norm = torch.linalg.vector_norm(accel_mean - ba)
    I3 = torch.eye(3, dtype=dtype, device=device)
    S_v = s.cov[6:9, 6:9] + cfg.zuv_sigma ** 2 * I3
    chi2_v = s.vel @ _solve(S_v, s.vel)
    ok = ((torch.abs(f_norm - cfg.gravity) < cfg.gravity_accel_gate)
          & (chi2_v < cfg.zuv_chi2_gate) & (is_static > 0))
    R_eff = torch.where(
        ok, torch.full((3,), cfg.gravity_sigma ** 2, dtype=dtype,
                       device=device), 1e12)

    # Right perturbation R ← R·Exp(δθ): h ≈ pred + g·[u]× δθ + δb_a.
    H = torch.cat([cfg.gravity * lie.hat(u),
                   torch.zeros((3, 6), dtype=dtype, device=device), I3,
                   torch.zeros((3, D - 12), dtype=dtype, device=device)], 1)
    return _gated_update(cfg, s, H, r, R_eff)


def zero_velocity_update(
    cfg: VioConfig,
    s: VioState,
    is_static: torch.Tensor,       # scalar 0/1 motion-detection verdict
) -> VioState:
    """ROVIO's ZeroVelocityUpdate: measure v = 0 when the motion detector
    says static AND the measurement passes the Mahalanobis gate
    (cfg.zuv_chi2_gate); otherwise the rows get variance 1e12."""
    dtype, device = s.pose.dtype, s.pose.device
    D = s.cov.shape[0]
    I3 = torch.eye(3, dtype=dtype, device=device)
    H = torch.cat([torch.zeros((3, 6), dtype=dtype, device=device), I3,
                   torch.zeros((3, D - 9), dtype=dtype, device=device)], 1)
    r = -s.vel
    S_nom = H @ s.cov @ H.mT + cfg.zuv_sigma ** 2 * I3
    chi2 = r @ _solve(S_nom, r)
    ok = (is_static > 0) & (chi2 < cfg.zuv_chi2_gate)
    R_eff = torch.where(
        ok, torch.full((3,), cfg.zuv_sigma ** 2, dtype=dtype,
                       device=device), 1e12)
    return _gated_update(cfg, s, H, r, R_eff)


def detect_no_motion(cfg: VioConfig, accel, gyro, dts) -> torch.Tensor:
    """Window-level motion detection (ROVIO MotionDetection block): static
    iff mean |ω| and the std of ‖accel‖ are both under threshold."""
    live = (dts > 0).to(accel.dtype)
    n = torch.clamp(torch.sum(live), min=1.0)
    gyro_mag = torch.linalg.vector_norm(gyro, dim=-1)
    mean_w = torch.sum(gyro_mag * live) / n
    a_mag = torch.linalg.vector_norm(accel, dim=-1)
    mean_a = torch.sum(a_mag * live) / n
    var_a = torch.sum((a_mag - mean_a) ** 2 * live) / n
    return ((mean_w < cfg.zuv_gyro_th)
            & (torch.sqrt(var_a) < cfg.zuv_accel_th)).to(accel.dtype)


def _boxminus(cfg: VioConfig, s_a: VioState, s_b: VioState) -> torch.Tensor:
    """Error vector of a relative to b (right convention)."""
    dq = lie.quat_log(lie.quat_mul(
        lie.quat_conjugate(lie.pose_quat(s_b.pose)), lie.pose_quat(s_a.pose)))
    return torch.cat([
        dq,
        lie.pose_trans(s_a.pose) - lie.pose_trans(s_b.pose),
        s_a.vel - s_b.vel,
        s_a.bias - s_b.bias,
        (s_a.landmarks - s_b.landmarks).reshape(-1),
    ])


# ---------------------------------------------------------------------------
# Landmark lifecycle
# ---------------------------------------------------------------------------

def init_landmarks(
    cfg: VioConfig,
    s: VioState,
    uv: torch.Tensor,          # (M, 2) pixel per slot
    depth: torch.Tensor,       # (M,)
    depth_sigma: float,
    enable: torch.Tensor,      # (M,) bool: re-initialize this slot
) -> VioState:
    """(Re-)initialize every enabled landmark slot from a pixel + LiDAR
    depth (the useDepthFromLiDAR path, rovio.cfg:133-138). An enabled
    slot's covariance rows and columns are zeroed and its diagonal block
    set from the backprojection Jacobian; cross terms to the pose stay
    zero. Disabled slots keep their values through ``e·new + (1 − e)·old``
    exactly as the JAX loop over slots leaves them."""
    dtype, device = s.pose.dtype, s.pose.device
    M = cfg.num_landmarks
    pose_ic = const(tuple(map(float, cfg.pose_ic)), dtype, device)
    pose_wc = lie.pose_compose(s.pose, pose_ic)
    q_wc = lie.pose_quat(pose_wc)
    l_w = (lie.quat_rotate(q_wc, C.backproject(cfg.cam, uv, depth))
           + lie.pose_trans(pose_wc))                         # (M, 3)

    # ∂(R_wc · backproject(u, v, d))/∂(u, v, d) in closed form (JAX takes
    # jacfwd; vmap(jacfwd) of this in torch returns float64 for f32 input).
    cam = cfg.cam
    zero = torch.zeros_like(depth)
    J_c = torch.stack([
        torch.stack([depth / cam.fx, zero, (uv[:, 0] - cam.cx) / cam.fx], -1),
        torch.stack([zero, depth / cam.fy, (uv[:, 1] - cam.cy) / cam.fy], -1),
        torch.stack([zero, zero, torch.ones_like(depth)], -1),
    ], 1)                                                    # (M, 3, 3)
    J = lie.quat_to_rot(q_wc) @ J_c
    ps2 = cfg.pixel_sigma ** 2
    rm = const((float(ps2), float(ps2), float(depth_sigma) ** 2), dtype,
               device)
    P_l = ((J * rm) @ J.mT
           + 1e-6 * torch.eye(3, dtype=dtype, device=device))

    e = enable.to(dtype)
    lm = e[:, None] * l_w + (1 - e[:, None]) * s.landmarks
    valid = torch.where(enable, 1.0, s.lm_valid)

    keep = torch.cat([torch.ones(IMU_DIM, dtype=dtype, device=device),
                      torch.repeat_interleave(1.0 - e, 3)])
    cov = s.cov * keep[None, :] * keep[:, None]
    # The diagonal landmark blocks take their new values by a select with
    # a constant block pattern, so the update carries a lane axis.
    blocks = cov[IMU_DIM:, IMU_DIM:].reshape(M, 3, M, 3)
    old = torch.diagonal(blocks, dim1=0, dim2=2).permute(2, 0, 1)  # (M,3,3)
    new = e[:, None, None] * P_l + (1 - e[:, None, None]) * old
    on_diag = torch.eye(M, dtype=torch.bool, device=device)[:, None, :, None]
    blocks = torch.where(on_diag, new[:, :, None, :], blocks)
    cov = torch.cat([cov[:IMU_DIM], torch.cat(
        [cov[IMU_DIM:, :IMU_DIM], blocks.reshape(3 * M, 3 * M)], 1)], 0)
    return s._replace(landmarks=lm, lm_valid=valid, cov=cov)


def init_landmark(
    cfg: VioConfig,
    s: VioState,
    slot,                      # int or 0-d int tensor
    uv: torch.Tensor,          # (2,)
    depth: torch.Tensor,       # ()
    depth_sigma: float,
    enable,                    # bool or 0-d bool tensor
) -> VioState:
    """(Re-)initialize landmark ``slot`` alone: :func:`init_landmarks`
    with every other slot disabled."""
    M = cfg.num_landmarks
    hit = torch.arange(M, device=s.pose.device) == slot
    return init_landmarks(
        cfg, s, torch.where(hit[:, None], uv, 0.0),
        torch.where(hit, depth, 1.0), depth_sigma, hit & enable)


def twist_covariance(cfg: VioConfig, s: VioState) -> torch.Tensor:
    """6×6 twist covariance (v_body, ω_body) in nav_msgs order: the
    filter's world-frame velocity marginal rotated into the body frame, and
    the gyro white noise plus the gyro-bias marginal."""
    dtype, device = s.pose.dtype, s.pose.device
    I3 = torch.eye(3, dtype=dtype, device=device)
    R = lie.quat_rotate(lie.pose_quat(s.pose)[None], I3).mT   # columns
    Pv_body = R.mT @ s.cov[6:9, 6:9] @ R
    Pw = s.cov[12:15, 12:15] + cfg.cov_gyro * I3
    return torch.block_diag(Pv_body, Pw)


def pose_covariance(cfg: VioConfig, s: VioState) -> torch.Tensor:
    """6×6 pose covariance in (trans, rot) order: the internal (θ, p)
    block with both halves swapped."""
    return torch.roll(s.cov[:6, :6], shifts=(3, 3), dims=(0, 1))

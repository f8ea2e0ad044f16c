"""Batched SO(3) / SE(3) Lie-group operations in PyTorch.

Port of ``vil_sensor_fusion_tpu/core/lie.py`` with the same conventions:

- Quaternions are Hamilton convention, stored ``(w, x, y, z)``.
- Rotation matrices act on column vectors: ``v_world = R @ v_body``.
- SE(3) tangent vectors are ordered ``(rho[3], theta[3])``; se3 exp/log use
  the full SE(3) exponential with the V-matrix.
- All ops broadcast over arbitrary leading batch dimensions, and dtype and
  device follow the inputs.
- Every op is a pure function of its inputs (no in-place writes), so
  ``torch.func.jacfwd`` / ``vmap`` can trace through it.
"""

from __future__ import annotations

import torch

from .. import DEFAULT_DEVICE

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -x, -y, -z], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., 1:]
    qw = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    r = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (w,x,y,z), branchless Shepperd
    (all four candidates computed, selected with ``torch.where``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    one = torch.ones_like(tr)

    s0 = torch.sqrt(torch.clamp(one + tr, min=_EPS)) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = torch.sqrt(torch.clamp(one + m00 - m11 - m22, min=_EPS)) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = torch.sqrt(torch.clamp(one - m00 + m11 - m22, min=_EPS)) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = torch.sqrt(torch.clamp(one - m00 - m11 + m22, min=_EPS)) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = torch.where(q[..., :1] < 0.0, -q, q)
    return quat_normalize(q)


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so w >= 0 (double cover canonicalization)."""
    return torch.where(q[..., :1] < 0.0, -q, q)


# ---------------------------------------------------------------------------
# SO(3) exp / log and Jacobians
# ---------------------------------------------------------------------------

def hat(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def vee(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def so3_exp_quat(theta: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion, Taylor-safe near 0."""
    angle_sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle_sq, min=0.0))
    half = 0.5 * angle
    small = angle_sq < _EPS
    k = torch.where(small, 0.5 - angle_sq / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, angle))
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> rotation matrix (Rodrigues), Taylor-safe."""
    angle_sq = torch.sum(theta * theta, dim=-1)[..., None, None]
    angle = torch.sqrt(torch.clamp(angle_sq, min=0.0))
    small = angle_sq < _EPS
    safe = torch.where(small, 1.0, angle)
    A = torch.where(small, 1.0 - angle_sq / 6.0, torch.sin(angle) / safe)
    B = torch.where(small, 0.5 - angle_sq / 24.0,
                    (1.0 - torch.cos(angle)) / (safe * safe))
    K = hat(theta)
    return _eye3_like(K) + A * K + B * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, via quaternion (stable)."""
    return quat_log(rot_to_quat(R))


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector, Taylor-safe; handles double cover."""
    q = quat_canonical(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm_sq = torch.sum(v * v, dim=-1, keepdim=True)
    vnorm = torch.sqrt(torch.clamp(vnorm_sq, min=0.0))
    small = vnorm_sq < _EPS
    angle = 2.0 * torch.atan2(vnorm, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                    angle / torch.where(small, 1.0, vnorm))
    return k * v


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): exp(theta+d) ≈ exp(J_l d) exp(theta)."""
    angle_sq = torch.sum(theta * theta, dim=-1)[..., None, None]
    angle = torch.sqrt(torch.clamp(angle_sq, min=0.0))
    small = angle_sq < _EPS
    safe = torch.where(small, 1.0, angle)
    B = torch.where(small, 0.5 - angle_sq / 24.0,
                    (1.0 - torch.cos(angle)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - angle_sq / 120.0,
                    (safe - torch.sin(angle)) / (safe * safe * safe))
    K = hat(theta)
    return _eye3_like(K) + B * K + C * (K @ K)


def so3_right_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(theta) = J_l(-theta)."""
    return so3_left_jacobian(-theta)


def so3_left_jacobian_inv(theta: torch.Tensor) -> torch.Tensor:
    angle_sq = torch.sum(theta * theta, dim=-1)[..., None, None]
    angle = torch.sqrt(torch.clamp(angle_sq, min=0.0))
    small = angle_sq < _EPS
    safe = torch.where(small, 1.0, angle)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + angle_sq / 720.0,
        (1.0 / (safe * safe)) - (1.0 + torch.cos(angle))
        / (2.0 * safe * torch.sin(angle) + _EPS * small.to(theta.dtype)),
    )
    K = hat(theta)
    return _eye3_like(K) - 0.5 * K + cot_term * (K @ K)


def so3_right_jacobian_inv(theta: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian_inv(-theta)


# ---------------------------------------------------------------------------
# SE(3): pose = (q[4], t[3]) packed as a 7-vector [qw qx qy qz tx ty tz]
# ---------------------------------------------------------------------------

def pose_identity(dtype=torch.float32, device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=device)


def pose_make(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def pose_quat(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def pose_trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:7]


def pose_compose(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """T1 * T2 : first apply T2, then T1 (world_T_a ∘ a_T_b = world_T_b)."""
    q1 = pose_quat(p1)
    q = quat_mul(q1, pose_quat(p2))
    t = pose_trans(p1) + quat_rotate(q1, pose_trans(p2))
    return pose_make(quat_normalize(q), t)


def pose_inverse(p: torch.Tensor) -> torch.Tensor:
    qi = quat_conjugate(pose_quat(p))
    ti = -quat_rotate(qi, pose_trans(p))
    return pose_make(qi, ti)


def pose_between(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """T1^-1 * T2 — GTSAM's Pose3::between, used by BetweenFactor."""
    return pose_compose(pose_inverse(p1), p2)


def pose_transform_points(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points: R @ x + t, broadcasting pose over points."""
    return (quat_rotate(pose_quat(p)[..., None, :], pts)
            + pose_trans(p)[..., None, :])


def pose_ref_delta(before: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """The reference's ad-hoc 'poseDiff' (SensorManagerRos.cpp:122-158):
    translation rotated into the *before* body frame, rotation composed as
    q2 * q1^-1 (a world-frame/left delta). Reproduced exactly for parity."""
    q1, q2 = pose_quat(before), pose_quat(after)
    x1, x2 = pose_trans(before), pose_trans(after)
    dxr = quat_rotate(quat_conjugate(q1), x2 - x1)
    qr = quat_mul(q2, quat_conjugate(q1))
    return pose_make(quat_normalize(qr), dxr)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. xi = (rho[3], theta[3]) -> pose 7-vector."""
    rho, theta = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(theta)
    V = so3_left_jacobian(theta)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return pose_make(q, t)


def se3_log(p: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm. pose -> (rho[3], theta[3])."""
    theta = quat_log(pose_quat(p))
    Vinv = so3_left_jacobian_inv(theta)
    rho = torch.einsum("...ij,...j->...i", Vinv, pose_trans(p))
    return torch.cat([rho, theta], dim=-1)


def pose_retract(p: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right retraction: p ⊞ xi = p * Exp(xi)  (GTSAM Pose3::retract EXPMAP)."""
    return pose_compose(p, se3_exp(xi))


def pose_local(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Local coordinates: Log(p1^-1 * p2) (right-invariant error)."""
    return se3_log(pose_between(p1, p2))


def pose_adjoint(p: torch.Tensor) -> torch.Tensor:
    """6x6 Adjoint of SE(3) with (rho, theta) ordering:
    Ad = [[R, [t]x R], [0, R]]."""
    R = quat_to_rot(pose_quat(p))
    tR = hat(pose_trans(p)) @ R
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# Euler angles (XYZ fixed-axis roll/pitch/yaw, tf.transformations 'sxyz')
# ---------------------------------------------------------------------------

def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw), ZYX intrinsic == sxyz static."""
    w, x, y, z = q.unbind(-1)
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    roll, pitch, yaw = rpy.unbind(-1)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def rotation_angle(q: torch.Tensor) -> torch.Tensor:
    """Absolute rotation angle = 2*acos(|w|) (diagnostics.py:114 semantics)."""
    w = torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0)
    return 2.0 * torch.acos(w)

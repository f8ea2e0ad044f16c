"""Synthetic sensor streams with exact ground truth.

Port of ``vil_sensor_fusion_tpu/data/synthetic.py`` (``trajectory``,
``circle``, ``straight_tunnel``, ``figure_eight``, ``sample_imu``,
``sample_odometry``, ``sample_ground_truth``). Trajectories
are smooth functions of a scalar time tensor; velocity, acceleration and
body rate come from forward-mode autodiff (``torch.func.jvp`` along the
scalar time, which is the ``jax.jacfwd`` of a scalar-input function), and
per-sample evaluation is ``torch.func.vmap``. Trajectories are evaluated in
float64 and returned in the dtype of ``t``: forward-mode AD on a 0-dim
float32 primal promotes its tangent to float64 (a Python-scalar factor
counts as a double there), which then fails mixed-dtype matmuls. Noise is
drawn from a caller's ``torch.Generator``; its numbers differ from JAX's
PRNG for the same seed.

Conventions: world frame z-up, gravity (0,0,-g); the IMU measures specific
force f_b = Rᵀ(a_w − g_w) and body angular rate ω_b = vee(Rᵀ Ṙ).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jvp, vmap

from ..core import lie


class Trajectory(NamedTuple):
    """Analytic trajectory: all samplable at a scalar time tensor."""

    pose_fn: Callable      # t -> (7,) pose
    vel_fn: Callable       # t -> (3,) world velocity
    acc_fn: Callable       # t -> (3,) world acceleration
    omega_fn: Callable     # t -> (3,) body angular rate


class ImuStream(NamedTuple):
    times: torch.Tensor    # (N,)
    accel: torch.Tensor    # (N, 3) specific force
    gyro: torch.Tensor     # (N, 3) angular rate


class OdometryStream(NamedTuple):
    times: torch.Tensor    # (M,)
    poses: torch.Tensor    # (M, 7) world pose (noisy)
    cov: torch.Tensor      # (M, 6, 6) pose covariance (rho, theta order)


class GroundTruth(NamedTuple):
    times: torch.Tensor
    poses: torch.Tensor    # (M, 7)
    vels: torch.Tensor     # (M, 3)


def _d_dt(fn: Callable) -> Callable:
    """Time derivative of ``fn`` at a scalar t: one forward-mode pass with
    tangent 1 (``jacfwd`` would build its basis in the default dtype)."""
    def d(t):
        return jvp(fn, (t,), (torch.ones_like(t),))[1]
    return d


def trajectory(pos_fn: Callable, rot_fn: Callable) -> Trajectory:
    """Trajectory from analytic position (t->(3,)) and rotation
    (t->(3,3)) functions via forward-mode autodiff."""
    vel_fn = _d_dt(pos_fn)
    acc_fn = _d_dt(vel_fn)
    rot_dot = _d_dt(rot_fn)

    def omega_fn(t):
        return lie.vee(rot_fn(t).T @ rot_dot(t))

    def pose_fn(t):
        return lie.pose_make(lie.rot_to_quat(rot_fn(t)), pos_fn(t))

    def in_f64(fn):
        def f(t):
            return fn(t.to(torch.float64)).to(t.dtype)
        return f

    return Trajectory(in_f64(pose_fn), in_f64(vel_fn), in_f64(acc_fn),
                      in_f64(omega_fn))


def circle(radius: float = 20.0, period: float = 30.0,
           z_amp: float = 0.5, z_period: float = 7.0) -> Trajectory:
    """Car driving a circle with gentle height oscillation, yaw tangent to
    the path."""
    w = 2.0 * torch.pi / period
    wz = 2.0 * torch.pi / z_period

    def pos_fn(t):
        return torch.stack([radius * torch.cos(w * t),
                            radius * torch.sin(w * t),
                            z_amp * torch.sin(wz * t)])

    def rot_fn(t):
        yaw = w * t + torch.pi / 2.0  # tangent direction
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t, yaw]))

    return trajectory(pos_fn, rot_fn)


def straight_tunnel(speed: float = 8.0, sway: float = 0.02) -> Trajectory:
    """Constant-velocity straight line (x-axis) with tiny sway: the
    translation-degenerate "tunnel" drive, where ICP sees two parallel
    walls and the along-track direction is unobservable."""
    def pos_fn(t):
        return torch.stack([speed * t, sway * torch.sin(0.7 * t), 0.0 * t])

    def rot_fn(t):
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t,
                                        sway * torch.sin(0.3 * t)]))

    return trajectory(pos_fn, rot_fn)


def figure_eight(radius: float = 15.0, period: float = 40.0) -> Trajectory:
    """Lemniscate path: richer excitation of all axes; yaw along the
    velocity."""
    w = 2.0 * torch.pi / period

    def pos_fn(t):
        return torch.stack([radius * torch.sin(w * t),
                            radius * torch.sin(w * t) * torch.cos(w * t),
                            0.3 * torch.sin(3.0 * w * t)])

    vx = _d_dt(pos_fn)

    def rot_fn(t):
        v = vx(t)
        yaw = torch.atan2(v[1], v[0])
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t, yaw]))

    return trajectory(pos_fn, rot_fn)


def _normal(shape, generator: torch.Generator, like: torch.Tensor):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def sample_imu(
    traj: Trajectory,
    times: torch.Tensor,
    gravity: float = 9.81,
    accel_noise: float = 0.0,
    gyro_noise: float = 0.0,
    accel_bias: torch.Tensor | None = None,
    gyro_bias: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> ImuStream:
    """Ideal IMU measurements along the trajectory, plus bias and white
    noise (noise only with a ``generator``)."""
    g_w = torch.tensor([0.0, 0.0, -gravity], dtype=times.dtype,
                       device=times.device)

    def one(t):
        R = lie.quat_to_rot(lie.pose_quat(traj.pose_fn(t)))
        return R.T @ (traj.acc_fn(t) - g_w), traj.omega_fn(t)

    f, w = vmap(one)(times)
    if accel_bias is not None:
        f = f + accel_bias
    if gyro_bias is not None:
        w = w + gyro_bias
    if generator is not None and (accel_noise > 0 or gyro_noise > 0):
        f = f + accel_noise * _normal(f.shape, generator, f)
        w = w + gyro_noise * _normal(w.shape, generator, w)
    return ImuStream(times=times, accel=f, gyro=w)


def sample_odometry(
    traj: Trajectory,
    times: torch.Tensor,
    trans_noise: float = 0.0,
    rot_noise: float = 0.0,
    generator: torch.Generator | None = None,
) -> OdometryStream:
    """A world-frame odometry stream (what the VIO/LOAM front-ends publish)
    with optional white pose noise, plus a matching covariance."""
    poses = vmap(traj.pose_fn)(times)
    M = times.shape[0]
    if generator is not None and (trans_noise > 0 or rot_noise > 0):
        xi = torch.cat([trans_noise * _normal((M, 3), generator, poses),
                        rot_noise * _normal((M, 3), generator, poses)], -1)
        poses = lie.pose_retract(poses, xi)
    diag = torch.tensor([max(trans_noise, 1e-4) ** 2] * 3
                        + [max(rot_noise, 1e-4) ** 2] * 3,
                        dtype=times.dtype, device=times.device)
    cov = torch.diag(diag).expand(M, 6, 6).clone()
    return OdometryStream(times=times, poses=poses, cov=cov)


def sample_ground_truth(traj: Trajectory,
                        times: torch.Tensor) -> GroundTruth:
    """Exact poses and world velocities of ``traj`` at ``times``."""
    return GroundTruth(times=times, poses=vmap(traj.pose_fn)(times),
                       vels=vmap(traj.vel_fn)(times))

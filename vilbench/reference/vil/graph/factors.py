"""Factor residuals and their linearization for the fixed-lag smoother.

Port of ``vil_sensor_fusion_tpu/graph/factors.py``: CombinedImuFactor,
BetweenFactor<Pose3>, the unary pose prior and the 15-dim state prior.
Jacobians come from forward-mode autodiff (``torch.func.jacfwd``) over the
tangent perturbations, as ``jax.jacfwd`` does in the JAX package.

Batching: the linearize functions take states with any leading batch axes
and differentiate w.r.t. ONE shared (15,) tangent per endpoint. Each batch
element's residual depends only on its own state, so the Jacobian of the
(..., n) residual w.r.t. that shared tangent is exactly the stack of the
per-element Jacobians, (..., n, 15) — the explicit batch dimension that
replaces the JAX package's ``vmap``.

State tangent order: ``[rho(3) | theta(3) | dvel(3) | dba(3) | dbg(3)]``.
IMU residual order: ``(r_theta, r_pos, r_vel, r_ba, r_bg)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..core import lie
from ..core import preintegration as pre

STATE_DIM = 15  # per-keyframe tangent dimension


class KeyframeStates(NamedTuple):
    """A window of W keyframe states (struct-of-arrays)."""

    poses: torch.Tensor   # (W, 7)
    vels: torch.Tensor    # (W, 3)
    biases: torch.Tensor  # (W, 6)

    @property
    def window(self) -> int:
        return self.poses.shape[-2]


def retract_state(pose, vel, bias, delta):
    """Apply a 15-dim tangent update to one keyframe state."""
    pose_n = lie.pose_retract(pose, delta[..., 0:6])
    return pose_n, vel + delta[..., 6:9], bias + delta[..., 9:15]


def retract_window(states: KeyframeStates, delta: torch.Tensor) -> KeyframeStates:
    """Apply a (W, 15) tangent update to the whole window."""
    return KeyframeStates(
        poses=lie.pose_retract(states.poses, delta[..., 0:6]),
        vels=states.vels + delta[..., 6:9],
        biases=states.biases + delta[..., 9:15],
    )


def local_window(ref: KeyframeStates, x: KeyframeStates) -> torch.Tensor:
    """(W, 15) tangent of x relative to ref: x = ref ⊞ local(ref, x)."""
    dpose = lie.pose_local(ref.poses, x.poses)
    return torch.cat([dpose, x.vels - ref.vels, x.biases - ref.biases], dim=-1)


# ---------------------------------------------------------------------------
# Residuals (unwhitened)
# ---------------------------------------------------------------------------

def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def imu_residual(pose_i, vel_i, bias_i, pose_j, vel_j, bias_j,
                 pim: pre.PreintegratedImu, gravity: torch.Tensor):
    """CombinedImuFactor 15-dim residual (Forster et al. RSS'15 eq. 45 plus
    bias random-walk rows), ordered (r_theta, r_pos, r_vel, r_ba, r_bg)."""
    db = bias_i - pim.bias_hat
    dba, dbg = db[..., :3], db[..., 3:6]

    dR_corr = pim.delta_R @ lie.so3_exp(_mv(pim.dR_dbg, dbg))
    dv_corr = pim.delta_v + _mv(pim.dv_dba, dba) + _mv(pim.dv_dbg, dbg)
    dp_corr = pim.delta_p + _mv(pim.dp_dba, dba) + _mv(pim.dp_dbg, dbg)

    Ri = lie.quat_to_rot(lie.pose_quat(pose_i))
    RiT = Ri.mT
    Rj = lie.quat_to_rot(lie.pose_quat(pose_j))
    pi = lie.pose_trans(pose_i)
    pj = lie.pose_trans(pose_j)
    dt = pim.delta_t[..., None]

    r_theta = lie.so3_log(dR_corr.mT @ RiT @ Rj)
    r_vel = _mv(RiT, vel_j - vel_i - gravity * dt) - dv_corr
    r_pos = _mv(RiT, pj - pi - vel_i * dt - 0.5 * gravity * dt * dt) - dp_corr
    r_bias = bias_j - bias_i
    return torch.cat([r_theta, r_pos, r_vel, r_bias], dim=-1)


def between_residual(pose_i, pose_j, measured) -> torch.Tensor:
    """BetweenFactor<Pose3> 6-dim residual Log(measured⁻¹ · (Tᵢ⁻¹ Tⱼ)),
    ordered (rho, theta)."""
    pred = lie.pose_between(pose_i, pose_j)
    return lie.se3_log(lie.pose_compose(lie.pose_inverse(measured), pred))


def prior_residual(pose, vel, bias, prior_pose, prior_vel, prior_bias):
    """15-dim prior residual ordered like the state tangent."""
    dpose = lie.pose_local(prior_pose, pose)
    return torch.cat([dpose, vel - prior_vel, bias - prior_bias], dim=-1)


def pose_prior_residual(pose, measured) -> torch.Tensor:
    """6-dim unary pose residual Log(measured⁻¹ · T) (PriorFactor<Pose3>)."""
    return lie.pose_local(measured, pose)


# ---------------------------------------------------------------------------
# Linearization: residual + Jacobians wrt the endpoint tangents
# ---------------------------------------------------------------------------

def _zero_tangent(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((STATE_DIM,), dtype=x.dtype, device=x.device)


def _with_value(fn):
    """fn -> fn returning (value, value): jacfwd's ``has_aux`` then hands
    back the residual itself alongside the Jacobians."""
    def f(*args):
        r = fn(*args)
        return r, r
    return f


def linearize_imu_factor(pose_i, vel_i, bias_i, pose_j, vel_j, bias_j,
                         pim: pre.PreintegratedImu, gravity):
    """Returns (r[..., 15], A_i[..., 15, 15], A_j[..., 15, 15])."""

    def r_of(di, dj):
        pi, vi, bi = retract_state(pose_i, vel_i, bias_i, di)
        pj, vj, bj = retract_state(pose_j, vel_j, bias_j, dj)
        return imu_residual(pi, vi, bi, pj, vj, bj, pim, gravity)

    z = _zero_tangent(pose_i)
    (A_i, A_j), r = jacfwd(_with_value(r_of), argnums=(0, 1),
                           has_aux=True)(z, z)
    return r, A_i, A_j


def linearize_between_factor(pose_i, pose_j, measured):
    """Returns (r[..., 6], A_i[..., 6, 15], A_j[..., 6, 15])."""

    def r_of(di, dj):
        pi = lie.pose_retract(pose_i, di[0:6])
        pj = lie.pose_retract(pose_j, dj[0:6])
        return between_residual(pi, pj, measured)

    z = _zero_tangent(pose_i)
    (A_i, A_j), r = jacfwd(_with_value(r_of), argnums=(0, 1),
                           has_aux=True)(z, z)
    return r, A_i, A_j


def linearize_pose_prior(pose, measured):
    """Returns (r[..., 6], A[..., 6, 15]) for a unary pose prior."""

    def r_of(d):
        return pose_prior_residual(lie.pose_retract(pose, d[0:6]), measured)

    A, r = jacfwd(_with_value(r_of), has_aux=True)(_zero_tangent(pose))
    return r, A


def linearize_prior_factor(pose, vel, bias, prior_pose, prior_vel, prior_bias):
    """Returns (r[..., 15], A[..., 15, 15])."""

    def r_of(d):
        p, v, b = retract_state(pose, vel, bias, d)
        return prior_residual(p, v, b, prior_pose, prior_vel, prior_bias)

    A, r = jacfwd(_with_value(r_of), has_aux=True)(_zero_tangent(pose))
    return r, A


def info_from_cov(cov: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Information matrix Λ = Σ⁻¹ via Cholesky (symmetrized).

    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite, where ``jnp.linalg.cholesky`` returns NaN. ``cholesky_ex``
    plus an explicit NaN fill keeps the JAX behaviour: the NaN propagates
    and the engine's health guard rejects the event."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    covs = 0.5 * (cov + cov.mT) + jitter * eye
    L, info = torch.linalg.cholesky_ex(covs)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    Linv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    return Linv.mT @ Linv

"""Trajectory diagnostics: the reference's online diagnostics node
(gtsam_fusion/python/diagnostics.py:33-141, DiagnosticMessage) as one
batched computation over aligned (estimate, ground-truth) pose arrays, plus
the ATE/RPE metrics of the offline evaluation.

Port of ``vil_sensor_fusion_tpu/eval/diagnostics.py``; everything runs on
the device of the given poses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie


class DiagnosticSeries(NamedTuple):
    """All DiagnosticMessage fields as (T,) series."""

    times: torch.Tensor
    gt_distance: torch.Tensor         # cumulative GT distance travelled
    abs_dist_err: torch.Tensor        # |t_est - t_gt| at each time
    abs_rot_err: torch.Tensor         # 2·acos(|w|) of the error quaternion
    relative_dist_err: torch.Tensor   # abs_dist_err / gt_distance
    abs_linear_vel_err: torch.Tensor  # |Δt_est - Δt_gt| per step
    abs_rot_vel_err: torch.Tensor     # angle of ΔR_gt · ΔR_est⁻¹ per step
    rel_linear_vel_err: torch.Tensor
    rel_rot_vel_err: torch.Tensor
    err_pose: torch.Tensor            # (T, 7) gt⁻¹ · est


def diagnostics(
    times: torch.Tensor,
    est_poses: torch.Tensor,
    gt_poses: torch.Tensor,
) -> DiagnosticSeries:
    """The DiagnosticMessage stream over an aligned trajectory. The
    reference's per-window transforms become first differences; its ``Inf``
    for a zero denominator is kept."""
    zero = torch.zeros((1,), dtype=est_poses.dtype, device=est_poses.device)
    err = lie.pose_between(gt_poses, est_poses)
    abs_dist = torch.linalg.vector_norm(lie.pose_trans(err), dim=-1)
    abs_rot = lie.rotation_angle(lie.pose_quat(err))

    def deltas(poses):
        d = lie.pose_between(poses[:-1], poses[1:])
        dt_ = torch.linalg.vector_norm(lie.pose_trans(d), dim=-1)
        dr = lie.rotation_angle(lie.pose_quat(d))
        return torch.cat([zero, dt_]), torch.cat([zero, dr]), d

    gt_step_dist, gt_step_rot, gt_d = deltas(gt_poses)
    _, _, est_d = deltas(est_poses)
    gt_distance = torch.cumsum(gt_step_dist, dim=0)

    dvel = lie.pose_trans(est_d) - lie.pose_trans(gt_d)
    lin_vel_err = torch.cat([zero, torch.linalg.vector_norm(dvel, dim=-1)])
    dq = lie.quat_mul(lie.pose_quat(gt_d),
                      lie.quat_conjugate(lie.pose_quat(est_d)))
    rot_vel_err = torch.cat([zero, lie.rotation_angle(dq)])

    def safe_div(a, b):
        return torch.where(b == 0, torch.inf, a / torch.where(b == 0, 1.0, b))

    return DiagnosticSeries(
        times=times,
        gt_distance=gt_distance,
        abs_dist_err=abs_dist,
        abs_rot_err=abs_rot,
        relative_dist_err=safe_div(abs_dist, gt_distance),
        abs_linear_vel_err=lin_vel_err,
        abs_rot_vel_err=rot_vel_err,
        rel_linear_vel_err=safe_div(lin_vel_err, gt_step_dist),
        rel_rot_vel_err=safe_div(rot_vel_err, gt_step_rot),
        err_pose=err,
    )


def anchor_first_pose(est_poses: torch.Tensor,
                      gt_poses: torch.Tensor) -> torch.Tensor:
    """Re-anchor an estimated trajectory so its FIRST pose coincides with
    the ground truth's: est'ₖ = (gt₀ ∘ est₀⁻¹) ∘ estₖ — the reference's
    frame anchoring (carla_frame_transforms.py:32-86). Use
    :func:`umeyama_alignment` for the gauge-optimal alignment."""
    g = lie.pose_compose(gt_poses[0], lie.pose_inverse(est_poses[0]))
    return lie.pose_compose(g, est_poses)


def umeyama_alignment(
    est_t: torch.Tensor,     # (T, 3) estimated translations
    gt_t: torch.Tensor,      # (T, 3) ground-truth translations
    with_scale: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form SE(3) (optionally Sim(3)) alignment est → gt (Umeyama
    1991): (R (3,3), t (3,), s) minimising Σ‖gt − (s·R·est + t)‖²."""
    dtype, device = est_t.dtype, est_t.device
    mu_e = torch.mean(est_t, dim=0)
    mu_g = torch.mean(gt_t, dim=0)
    xe = est_t - mu_e
    xg = gt_t - mu_g
    cov = (xg.T @ xe) / est_t.shape[0]
    U, d, Vt = torch.linalg.svd(cov)
    one = torch.ones((), dtype=dtype, device=device)
    s_fix = torch.where(torch.linalg.det(U) * torch.linalg.det(Vt) < 0,
                        -one, one)
    S = torch.diag(torch.stack([one, one, s_fix]))
    R = U @ S @ Vt
    if with_scale:
        var_e = torch.mean(torch.sum(xe * xe, dim=-1))
        s = (torch.sum(d * torch.diagonal(S))
             / torch.clamp(var_e, min=1e-12))
    else:
        s = one
    t = mu_g - s * (R @ mu_e)
    return R, t, s


def ate_rmse(est_poses: torch.Tensor, gt_poses: torch.Tensor,
             align: bool = False) -> torch.Tensor:
    """Absolute trajectory error RMSE (translation). ``align``: Umeyama
    SE(3)-align the estimate to GT first (gauge-free odometry)."""
    est_t = lie.pose_trans(est_poses)
    gt_t = lie.pose_trans(gt_poses)
    if align:
        R, t, s = umeyama_alignment(est_t, gt_t)
        est_t = s * (est_t @ R.T) + t
    err = est_t - gt_t
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))


def rpe(
    est_poses: torch.Tensor,
    gt_poses: torch.Tensor,
    stride: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Relative pose error over a fixed stride: (trans RMSE, rot RMSE)."""
    ed = lie.pose_between(est_poses[:-stride], est_poses[stride:])
    gd = lie.pose_between(gt_poses[:-stride], gt_poses[stride:])
    rel = lie.pose_between(gd, ed)
    t_err = torch.linalg.vector_norm(lie.pose_trans(rel), dim=-1)
    r_err = lie.rotation_angle(lie.pose_quat(rel))
    return (torch.sqrt(torch.mean(t_err * t_err)),
            torch.sqrt(torch.mean(r_err * r_err)))

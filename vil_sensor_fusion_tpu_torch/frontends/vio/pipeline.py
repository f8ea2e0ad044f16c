"""Per-frame VIO step: IMU propagation → gravity / zero-velocity
pseudo-measurements → iterated camera update → landmark replenishment, the
20 Hz odometry producer (/rovio/odometry), emitting pose + 6×6 covariance
for the degeneracy metrics and the fusion back-end.

Port of ``vil_sensor_fusion_tpu/frontends/vio/pipeline.py``; ``run``'s scan
is a loop over frames with the outputs stacked along a leading T axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import tracing as TR
from . import ekf as E


class VioFrameInput(NamedTuple):
    """Everything one camera frame brings (static shapes). Stacked along a
    leading T axis for :func:`run`."""

    accel: torch.Tensor        # (N, 3) IMU window since last frame
    gyro: torch.Tensor         # (N, 3)
    dts: torch.Tensor          # (N,)
    obs_uv: torch.Tensor       # (M, 2) tracked pixel per landmark slot
    obs_valid: torch.Tensor    # (M,)
    obs_depth: torch.Tensor    # (M,) LiDAR depth at the tracked pixel
                               # (0 = none) — continuous scale anchor
    new_uv: torch.Tensor       # (M, 2) replacement feature pixel per slot
    new_depth: torch.Tensor    # (M,)
    new_enable: torch.Tensor   # (M,) 1 ⇒ re-initialize this slot


class VioOutput(NamedTuple):
    pose: torch.Tensor         # (7,)
    vel: torch.Tensor          # (3,)
    cov: torch.Tensor          # (6, 6) pose covariance, (trans, rot) order
    twist_cov: torch.Tensor    # (6, 6) (v_body, ω_body), ekf.twist_covariance


def step(
    cfg: E.VioConfig,
    s: E.VioState,
    fin: VioFrameInput,
    depth_sigma: float = 0.1,
) -> tuple[E.VioState, VioOutput]:
    s = E.propagate(cfg, s, fin.accel, fin.gyro, fin.dts)
    if cfg.use_gravity_update or cfg.use_zero_velocity_update:
        static = E.detect_no_motion(cfg, fin.accel, fin.gyro, fin.dts)
    if cfg.use_gravity_update:
        live = (fin.dts > 0).to(s.pose.dtype)
        n = torch.clamp(torch.sum(live), min=1.0)
        accel_mean = torch.sum(fin.accel * live[:, None], dim=0) / n
        s = E.gravity_update(cfg, s, accel_mean, is_static=static)
    if cfg.use_zero_velocity_update:
        s = E.zero_velocity_update(cfg, s, static)
    s = E.update(cfg, s, fin.obs_uv, fin.obs_valid,
                 obs_depth=fin.obs_depth)
    s = E.init_landmarks(cfg, s, fin.new_uv, fin.new_depth, depth_sigma,
                         fin.new_enable > 0)
    return s, VioOutput(
        pose=s.pose, vel=s.vel, cov=E.pose_covariance(cfg, s),
        twist_cov=E.twist_covariance(cfg, s))


def run(
    cfg: E.VioConfig,
    s: E.VioState,
    frames: VioFrameInput,      # stacked (T, ·)
    depth_sigma: float = 0.1,
) -> tuple[E.VioState, VioOutput]:
    """Step over every frame on the device the inputs are on; outputs
    stacked (T, ·)."""
    outs = []
    with TR.span("vio.run"):
        TR.count("vio.frames", frames.accel.shape[0])
        for t in range(frames.accel.shape[0]):
            s, out = step(cfg, s, VioFrameInput(*(x[t] for x in frames)),
                          depth_sigma)
            outs.append(out)
        return s, VioOutput(*(torch.stack(f) for f in zip(*outs)))


def run_lanes(
    cfg: E.VioConfig,
    s: E.VioState,              # every leaf with a leading lane axis B
    frames: VioFrameInput,      # (B, T, ·)
    depth_sigma: float = 0.1,
) -> tuple[E.VioState, VioOutput]:
    """B frame streams at once, one set of ops per frame for all lanes:
    what ``jax.vmap(lambda s, f: run(cfg, s, f))`` computes (the bench's
    VIO stage). Outputs (B, T, ·)."""
    return torch.func.vmap(lambda s_, f: run(cfg, s_, f, depth_sigma))(
        s, frames)

"""Per-frame VIO step: IMU propagation → gravity / zero-velocity
pseudo-measurements → iterated camera update → landmark replenishment, the
20 Hz odometry producer (/rovio/odometry), emitting pose + 6×6 covariance
for the degeneracy metrics and the fusion back-end.

Port of ``vil_sensor_fusion_tpu/frontends/vio/pipeline.py``; ``run``'s scan
is a loop over frames with the outputs stacked along a leading T axis.

One loop: ``run`` and ``run_lanes`` loop :func:`step` over the frames
(``vmap``-ped over the lanes for ``run_lanes``) through
``_cudagraph.scan``, the third stage after the fusion engine and the LiDAR
odometry to replay on a card. There a key's first frame runs eagerly and
captures the whole step as one CUDA graph (it launches no hand-written
kernel, so nothing splits it), and every later frame of all lanes is one
replay; the values are the eager step's, bit for bit. CPU calls and calls
under a functorch transform or autograd take the eager step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import _cudagraph as CG
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
    with TR.span("vio.run"):
        TR.count("vio.frames", frames.accel.shape[0])
        return _scan(cfg, s, frames, depth_sigma, 0)


def run_lanes(
    cfg: E.VioConfig,
    s: E.VioState,              # every leaf with a leading lane axis B
    frames: VioFrameInput,      # (B, T, ·)
    depth_sigma: float = 0.1,
) -> tuple[E.VioState, VioOutput]:
    """B frame streams at once, one set of ops per frame for all lanes:
    what ``jax.vmap(lambda s, f: run(cfg, s, f))`` computes (the bench's
    VIO stage). On a card each frame of all lanes is one replay. Outputs
    (B, T, ·)."""
    with TR.span("vio.run"):
        TR.count("vio.frames", frames.accel.shape[1])
        return _scan(cfg, s, frames, depth_sigma, 1)


def _scan(cfg: E.VioConfig, s: E.VioState, frames: VioFrameInput,
          depth_sigma: float, axis: int) -> tuple[E.VioState, VioOutput]:
    """:func:`run`'s loop (``axis`` 0) and :func:`run_lanes`' (``axis`` 1,
    :func:`step` ``vmap``-ped over the lanes): one ``_cudagraph.scan`` of
    the step, replayed on a card as one graph. ``depth_sigma`` is baked
    into the step, so it is part of the key."""

    def one(s_, fin):
        return step(cfg, s_, fin, depth_sigma)

    fn = torch.func.vmap(one) if axis else one
    return CG.scan(lambda _: fn, s, frames, axis=axis,
                   graphed=CG.graph_device(s, frames) is not None,
                   key=(cfg, depth_sigma), name="vio")

"""Full VIL pipeline: VIO (20 Hz) + LiDAR odometry (10 Hz) + degeneracy
gate + factor-graph fusion (the reference's fusion.launch: ROVIO + LOAM +
degenerate_odometry_filter + gtsam_fusion_node), stage for stage:

    camera+IMU ─→ VIO (ekf)            ─ pose+cov @20Hz ──┐
    LiDAR      ─→ lidar odometry (ICP) ─ pose+cov+HESSIAN @10Hz
                      │                                   │
                      └→ log-det gate (keep/drop) ────────┤
    IMU ──────────────────────────────────────────────────┴→ fusion engine
                                                             → fused pose

Port of ``vil_sensor_fusion_tpu/fusion/vil.py:run_vil`` in its geometric
VIO mode. Not ported yet: the direct photometric VIO
(``VioConfig.use_photometric``), the model-parallel ``mesh``, and the bag
entry points (``run_vil_from_bag``, ``build_vio_frames_from_bag``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _precision
from .. import convert
from ..core import lie
from ..degeneracy import gate as DG
from ..frontends import lidar as L
from ..frontends import vio as V
from . import engine as E


class VilConfig(NamedTuple):
    vio: V.VioConfig = V.VioConfig()
    lidar: L.LidarOdomConfig = L.LidarOdomConfig()
    gate: DG.GateConfig = DG.GateConfig()
    # Per-sensor noise mirrors the reference's calibration (fusion_params
    # .yaml: rovio covariance 0.2, loam covariance 0.1).
    fusion: E.FusionConfig = E.FusionConfig(
        sensors=(
            E.SensorSpec(name="vio", optimize_after_odom=True,
                         use_odom_covariance=False,
                         covariance_linear=0.2, covariance_angular=0.2,
                         max_time_skip=0.1),
            E.SensorSpec(name="lidar", optimize_after_odom=False,
                         use_odom_covariance=False,
                         covariance_linear=0.1, covariance_angular=0.1,
                         max_time_skip=0.2),
        ),
    )


class VilResult(NamedTuple):
    fused: E.FusedOutput
    timeline: E.Timeline
    vio_out: V.VioOutput          # stacked (T_v, ·)
    lidar_out: L.LidarOdomResult  # stacked (T_l, ·)
    gate: DG.GateResult           # over lidar sweeps


def run_vil(
    cfg: VilConfig,
    # IMU stream (for preintegration in the fusion back-end):
    imu_times: torch.Tensor, imu_accel: torch.Tensor, imu_gyro: torch.Tensor,
    # VIO inputs:
    vio_times: np.ndarray, vio_frames: V.VioFrameInput,
    vio_state: V.VioState,
    # LiDAR inputs:
    lidar_times: np.ndarray, sweeps: L.Sweep, lidar_state: L.LidarOdomState,
    lidar_pose_guesses: torch.Tensor | None = None,
    lidar_guess_from_vio_idx: np.ndarray | None = None,
    # Fusion init:
    engine_state: E.EngineState = None,
) -> tuple[E.EngineState, VilResult]:
    """Run the full system over one sequence, on the device the inputs
    live on. The front-ends run first (they are causal); their odometry
    streams then drive the fusion engine.

    LiDAR registration priors come either from ``lidar_pose_guesses`` or
    from the VIO poses at the sweeps' times (``lidar_guess_from_vio_idx``);
    in ``guess_is_delta`` mode they are the VIO's relative motion between
    consecutive sweeps, with sweep 0 relative to the VIO initial pose."""
    _precision.require_full_f32()
    # --- Stage 1: VIO ------------------------------------------------------
    if cfg.vio.use_photometric:
        raise NotImplementedError(
            "the direct photometric VIO (VioConfig.use_photometric) is not "
            "ported yet: ROADMAP.md Queue 1 item 2")
    _, vio_out = V.run(cfg.vio, vio_state, vio_frames)

    # --- Stage 2: LiDAR odometry -------------------------------------------
    if lidar_guess_from_vio_idx is not None:
        sel_idx = torch.as_tensor(np.asarray(lidar_guess_from_vio_idx),
                                  device=vio_out.pose.device)
        vio_sel = vio_out.pose[sel_idx]
        if cfg.lidar.guess_is_delta:
            prev = torch.cat([vio_state.pose[None], vio_sel[:-1]], dim=0)
            lidar_pose_guesses = lie.pose_between(prev, vio_sel)
        else:
            lidar_pose_guesses = vio_sel
    _, lidar_out = L.odometry.run(cfg.lidar, lidar_state, sweeps,
                                  lidar_pose_guesses)

    # --- Stage 3: degeneracy gate on the ICP Hessian -----------------------
    gate_res = DG.logdet_gate(lidar_out.hessian, cfg.gate,
                              n_corr=lidar_out.n_corr)

    # --- Stage 4: fusion ----------------------------------------------------
    poses = engine_state.smoother.states.poses
    dtype, device = poses.dtype, poses.device
    # The LiDAR twist is the pose delta over the sweep period, so its
    # covariance is the registration covariance scaled by 1/Δt².
    lt = np.asarray(lidar_times)
    dt_l = float(np.median(np.diff(lt))) if len(lt) > 1 else 0.1
    lidar_cov = lidar_out.cov.cpu().numpy()
    tl = E.merge_timeline([
        (np.asarray(vio_times), vio_out.pose.cpu().numpy(),
         vio_out.cov.cpu().numpy(), np.ones(len(vio_times)),
         vio_out.twist_cov.cpu().numpy()),
        (lt, lidar_out.pose.cpu().numpy(), lidar_cov,
         gate_res.keep.cpu().numpy(), lidar_cov / max(dt_l, 1e-3) ** 2),
    ])
    tl = convert.to_torch(tl, device, dtype)
    es, fused = E.run(cfg.fusion, engine_state, tl, imu_times.to(dtype),
                      imu_accel.to(dtype), imu_gyro.to(dtype))
    return es, VilResult(fused=fused, timeline=tl, vio_out=vio_out,
                         lidar_out=lidar_out, gate=gate_res)

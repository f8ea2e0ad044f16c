"""Full VIL pipeline: VIO (20 Hz) + LiDAR odometry (10 Hz) + degeneracy
gate + factor-graph fusion (the reference's fusion.launch: ROVIO + LOAM +
degenerate_odometry_filter + gtsam_fusion_node), stage for stage:

    camera+IMU ─→ VIO (ekf)            ─ pose+cov @20Hz ──┐
    LiDAR      ─→ lidar odometry (ICP) ─ pose+cov+HESSIAN @10Hz
                      │                                   │
                      └→ log-det gate (keep/drop) ────────┤
    IMU ──────────────────────────────────────────────────┴→ fusion engine
                                                             → fused pose

Port of ``vil_sensor_fusion_tpu/fusion/vil.py``: ``run_vil`` over array
streams, and the raw-sensor bag entry points (``build_vio_frames_from_bag``,
``build_photo_inputs_from_bag``, ``run_vil_from_bag``: bag → organized
sweeps → LiDAR odometry, bag → images → tracker → EKF, gate, fusion). With
``VioConfig.use_photometric`` the VIO stage is the direct photometric
filter (``frontends/vio/photometric.run`` over :class:`PhotoInputs`: no KLT
stage, the patch alignment happens inside the EKF update). With
``LidarOdomConfig.emit_dists`` the LiDAR stage also returns the
perturbation-sweep distances (``lidar_out.dists``) that the experiment
harness (``eval/experiments.py``) turns into dist slopes. A ``mesh``
spreads the scan-to-map registration over the ranks of its model axis
(``parallel.ops.make_sharded_register``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE, _precision
from .. import convert
from ..core import lie
from ..data import ingest as IG
from ..degeneracy import gate as DG
from ..frontends import lidar as L
from ..frontends import vio as V
from ..frontends.vio import photometric as PH
from ..utils import tracing as TR
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


class PhotoInputs(NamedTuple):
    """Precomputed per-frame inputs of the direct photometric VIO path
    (``VioConfig.use_photometric=True``): the batched outputs of
    ``frontend.precompute_frames`` plus the per-frame IMU windows. There is
    no KLT tracking stage: alignment happens inside the iterated EKF update
    (``frontends.vio.photometric``)."""

    fe_cfg: object                # frontend.FrontendConfig (static)
    pyrs: tuple                   # L × (T, h_l, w_l)
    cand_uv: torch.Tensor         # (T, C, 2)
    cand_score: torch.Tensor      # (T, C)
    cand_depth: torch.Tensor      # (T, C)
    projs: torch.Tensor           # (T, P_pts, 3)
    imu_windows: tuple            # (accel (T,N,3), gyro (T,N,3), dts (T,N))


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
    # Model parallelism: a parallel.mesh.Mesh whose model axis spreads the
    # scan-to-map registration's points over ranks.
    mesh=None,
    # Direct photometric VIO (cfg.vio.use_photometric): stage 1 runs
    # frontends.vio.photometric.run over these precomputed frame inputs
    # instead of the geometric KLT + reprojection pipeline.
    photo_inputs: PhotoInputs | None = None,
) -> tuple[E.EngineState, VilResult]:
    """Run the full system over one sequence, on the device the inputs
    live on. The front-ends run first (they are causal); their odometry
    streams then drive the fusion engine.

    LiDAR registration priors come either from ``lidar_pose_guesses`` or
    from the VIO poses at the sweeps' times (``lidar_guess_from_vio_idx``);
    in ``guess_is_delta`` mode they are the VIO's relative motion between
    consecutive sweeps, with sweep 0 relative to the VIO initial pose.

    ``mesh``: a ``parallel.mesh.Mesh`` with a model axis of size N spreads
    ONE sequence's scan-to-map ICP over N ranks (``cli run
    --model-devices N``); every rank runs this call on the same inputs and
    gets the same result.

    Each stage is a program span (``utils.tracing``): ``vil.vio``,
    ``vil.lidar``, ``vil.gate``, ``vil.timeline`` (the host handoff
    between the front ends and the engine) and ``vil.fusion``; the
    counter ``vil.runs`` counts the calls."""
    _precision.require_full_f32()
    TR.count("vil.runs", 1)
    # --- Stage 1: VIO ------------------------------------------------------
    with TR.span("vil.vio"):
        if cfg.vio.use_photometric:
            if photo_inputs is None:
                raise ValueError(
                    "cfg.vio.use_photometric=True requires photo_inputs "
                    "(fusion.vil.PhotoInputs — see "
                    "build_photo_inputs_from_bag)")
            pi = photo_inputs
            _, vio_out = PH.run(cfg.vio, pi.fe_cfg,
                                PH.init_photo(cfg.vio, vio_state), pi.pyrs,
                                pi.cand_uv, pi.cand_score, pi.cand_depth,
                                pi.projs, pi.imu_windows)
        else:
            _, vio_out = V.run(cfg.vio, vio_state, vio_frames)

    # --- Stage 2: LiDAR odometry -------------------------------------------
    with TR.span("vil.lidar"):
        register_fn = None
        if mesh is not None:
            from ..parallel import ops as POPS

            register_fn = POPS.make_sharded_register(mesh, cfg.lidar.icp)
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
                                      lidar_pose_guesses,
                                      register_fn=register_fn)

    # --- Stage 3: degeneracy gate on the ICP Hessian -----------------------
    with TR.span("vil.gate"):
        gate_res = DG.logdet_gate(lidar_out.hessian, cfg.gate,
                                  n_corr=lidar_out.n_corr)

    # --- Stage 4: fusion ----------------------------------------------------
    poses = engine_state.smoother.states.poses
    dtype, device = poses.dtype, poses.device
    # The host handoff: both odometry streams come to the host, are merged
    # into one time-ordered timeline there and go back to the device. The
    # LiDAR twist is the pose delta over the sweep period, so its
    # covariance is the registration covariance scaled by 1/Δt².
    with TR.span("vil.timeline"):
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
    with TR.span("vil.fusion"):
        es, fused = E.run(cfg.fusion, engine_state, tl, imu_times.to(dtype),
                          imu_accel.to(dtype), imu_gyro.to(dtype))
    return es, VilResult(fused=fused, timeline=tl, vio_out=vio_out,
                         lidar_out=lidar_out, gate=gate_res)


def _bag_frame_streams(
    ba: IG.BagArrays,
    pose_ic,                       # (7,) imu_T_camera
    sweep_stride: int,
    dtype,
):
    """Shared bag→frame-stream prep, on the device of the bag's sweeps:
    per-frame IMU windows and the most recent sweep's points moved into
    the camera frame by the rig extrinsics alone (LiDAR at the IMU); the
    ≤1-sweep-period motion between sweep and frame is absorbed by the
    coarse depth association, as ROVIO's useDepthFromLiDAR
    (rovio.cfg:132-138)."""
    device = ba.sweeps.xyz.device
    imu_w = IG.imu_windows_from_stream(
        ba.imu_times, ba.imu_accel, ba.imu_gyro, ba.cam_times, dtype=dtype,
        device=device)
    T_l = len(ba.lidar_times)
    sw_idx = torch.as_tensor(np.clip(
        np.searchsorted(ba.lidar_times, ba.cam_times + 1e-9) - 1, 0, None),
        device=device)
    xyz = ba.sweeps.xyz[:, :, ::sweep_stride, :].reshape(T_l, -1, 3)[sw_idx]
    msk = ba.sweeps.mask[:, :, ::sweep_stride].reshape(T_l, -1)[sw_idx]
    pose_ci = lie.pose_inverse(torch.as_tensor(pose_ic, dtype=dtype,
                                               device=device))
    pts_cam = (lie.quat_rotate(lie.pose_quat(pose_ci)[None, None], xyz)
               + lie.pose_trans(pose_ci)[None, None])
    return imu_w, pts_cam.to(dtype), msk.to(dtype)


def build_vio_frames_from_bag(
    fe_cfg,
    ba: IG.BagArrays,
    pose_ic,                       # (7,) imu_T_camera
    num_slots: int,
    sweep_stride: int = 4,
    dtype=torch.float32,
) -> V.VioFrameInput:
    """Raw bag streams → VioFrameInput via the image tracker front-end, on
    the device of the bag's sweeps."""
    imu_w, pts_cam, msk = _bag_frame_streams(ba, pose_ic, sweep_stride, dtype)
    images = torch.as_tensor(ba.images, dtype=dtype, device=pts_cam.device)
    return V.frontend.build_frames(fe_cfg, images, pts_cam, msk, imu_w,
                                   num_slots)


def build_photo_inputs_from_bag(
    fe_cfg,
    ba: IG.BagArrays,
    pose_ic,                       # (7,) imu_T_camera
    sweep_stride: int = 4,
    dtype=torch.float32,
) -> PhotoInputs:
    """Raw bag streams → PhotoInputs for the direct photometric pipeline,
    on the device of the bag's sweeps: the batched half of the front-end
    only (pyramids, Shi-Tomasi candidates, projected sweeps, candidate
    depths), since the photometric update subsumes tracking."""
    imu_w, pts_cam, msk = _bag_frame_streams(ba, pose_ic, sweep_stride, dtype)
    images = torch.as_tensor(ba.images, dtype=dtype, device=pts_cam.device)
    pyrs = V.frontend.pyramids_batch(fe_cfg, images)
    cand_uv, cand_score, cand_depth, projs = V.frontend.candidates_batch(
        fe_cfg, images, pts_cam, msk)
    return PhotoInputs(fe_cfg=fe_cfg, pyrs=pyrs, cand_uv=cand_uv,
                       cand_score=cand_score, cand_depth=cand_depth,
                       projs=projs, imu_windows=imu_w)


def run_vil_from_bag(
    path,
    cfg: VilConfig | None = None,
    fe_cfg=None,
    pose_ic=None,
    topics: dict | None = None,
    sweep_stride: int = 4,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
    mesh=None,
):
    """Replay a raw-sensor bag through the FULL stack on ``device`` — bag →
    organized sweeps → LiDAR odometry, bag → images → tracker → EKF (or,
    with ``cfg.vio.use_photometric``, images → pyramids and candidates →
    the direct photometric EKF), degeneracy gate, fusion — one call
    reproducing fusion_carla.launch's job
    (gtsam_fusion/launch/fusion_carla.launch:13-97).

    ``mesh`` as in :func:`run_vil`. Returns (engine_state, VilResult,
    BagArrays)."""
    cfg = cfg or VilConfig()
    if pose_ic is None:
        pose_ic = cfg.vio.pose_ic
    fe_cfg = fe_cfg or V.FrontendConfig(cam=cfg.vio.cam)
    ba = IG.load_bag(path, dtype=dtype, device=device, **(topics or {}))
    photo_inputs = frames = None
    if cfg.vio.use_photometric:
        photo_inputs = build_photo_inputs_from_bag(
            fe_cfg, ba, pose_ic, sweep_stride=sweep_stride, dtype=dtype)
    else:
        frames = build_vio_frames_from_bag(
            fe_cfg, ba, pose_ic, cfg.vio.num_landmarks,
            sweep_stride=sweep_stride, dtype=dtype)

    # Initial state: GT odometry if recorded, else identity at rest (the
    # reference hardcodes identity priors — GraphManager.cpp:20-35).
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    vel0 = torch.zeros(3, dtype=dtype, device=device)
    if ba.gt_poses is not None and len(ba.gt_poses):
        pose0 = tensor(ba.gt_poses[0])
        if len(ba.gt_poses) > 1:
            dt = float(ba.gt_times[1] - ba.gt_times[0])
            vel0 = (tensor(ba.gt_poses[1, 4:7]) - pose0[4:7]) / max(dt, 1e-6)
    else:
        pose0 = lie.pose_identity(dtype, device=device)

    zeros6 = torch.zeros(6, dtype=dtype, device=device)
    vio_state = V.init(cfg.vio, pose0, vel0, zeros6)
    lidar_state = L.odometry.init(cfg.lidar, dtype, pose0=pose0)
    guess_idx = np.clip(
        np.searchsorted(ba.cam_times, ba.lidar_times + 1e-9) - 1, 0, None)
    t0 = tensor(min(float(ba.imu_times[0]), float(ba.cam_times[0])) - 1e-3)
    es = E.init(cfg.fusion, pose0, vel0, zeros6, t0)

    es, res = run_vil(
        cfg, tensor(ba.imu_times), tensor(ba.imu_accel), tensor(ba.imu_gyro),
        ba.cam_times, frames, vio_state,
        ba.lidar_times, ba.sweeps, lidar_state,
        lidar_guess_from_vio_idx=guess_idx, engine_state=es, mesh=mesh,
        photo_inputs=photo_inputs)
    return es, res, ba

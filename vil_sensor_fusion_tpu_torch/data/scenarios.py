"""Full-system synthetic scenario: the ``town`` drive.

Port of the ``town`` case of ``vil_sensor_fusion_tpu/data/scenarios.py``:
an analytic trajectory through a box town, sampled into an IMU stream, VIO
frames, raycast VLP-16 sweeps and ground truth at the VIO and LiDAR event
times. The VIO frames are synthetic feature tracks by default, or, with
``vio_from_images``, the image tracker's output on rendered frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from .. import DEFAULT_DEVICE, _tree
from ..core import lie
from ..frontends import vio as V
from ..frontends.lidar.rangeimage import Sweep
from . import raycast as rc
from . import synthetic as syn


class VilScenario(NamedTuple):
    traj: syn.Trajectory
    world: rc.World
    # IMU stream
    imu_times: torch.Tensor
    imu_accel: torch.Tensor
    imu_gyro: torch.Tensor
    # VIO
    vio_times: np.ndarray
    vio_frames: V.VioFrameInput
    # LiDAR
    lidar_times: np.ndarray
    sweeps: Sweep                   # stacked (T_l, R, A, ·)
    lidar_guess_idx: np.ndarray     # vio frame index per sweep
    gt_vio_poses: np.ndarray
    gt_lidar_poses: np.ndarray
    # Rendered frames (T_v, H, W) and the per-frame sweep points in the
    # camera frame + validity (T_v, P, 3) / (T_v, P), kept when
    # vio_from_images.
    images: object = None
    cam_points: object = None
    cam_point_valid: object = None


def _town_traj(speed: float = 4.0) -> syn.Trajectory:
    """Gently curving drive through the box town at sensor height 1.5 m."""
    def pos_fn(t):
        return torch.stack([speed * t, 2.0 * torch.sin(0.25 * t),
                            1.5 + 0.0 * t])

    def rot_fn(t):
        yaw = torch.atan2(2.0 * 0.25 * torch.cos(0.25 * t),
                          torch.ones_like(t) * speed)
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t, yaw]))

    return syn.trajectory(pos_fn, rot_fn)


def _camera_sweeps(sweeps: Sweep, lidar_times: np.ndarray,
                   vio_times: np.ndarray, poses_cam: torch.Tensor,
                   gt_lidar_poses: torch.Tensor, sweep_stride: int):
    """The most recent sweep per frame (frames before the first sweep use
    it), decimated in azimuth and moved into the frame's camera by ground
    truth: (pts_cam (T_v, P, 3), valid (T_v, P))."""
    T_l = len(lidar_times)
    sw_idx = np.clip(
        np.searchsorted(lidar_times, vio_times + 1e-9) - 1, 0, None)
    sel = torch.as_tensor(sw_idx, device=poses_cam.device)
    sw_xyz = sweeps.xyz[:, :, ::sweep_stride, :].reshape(T_l, -1, 3)[sel]
    sw_msk = sweeps.mask[:, :, ::sweep_stride].reshape(T_l, -1)[sel]
    pose_cl = lie.pose_compose(lie.pose_inverse(poses_cam),
                               gt_lidar_poses[sel])
    pts_cam = (lie.quat_rotate(lie.pose_quat(pose_cl)[:, None], sw_xyz)
               + lie.pose_trans(pose_cl)[:, None])
    return pts_cam, sw_msk


def build(
    kind: str = "town",
    duration: float = 4.0,
    vio_hz: float = 20.0,
    lidar_hz: float = 10.0,
    imu_hz: float = 200.0,
    vio_cfg: V.VioConfig | None = None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
    seed: int = 0,
    imu_accel_noise: float = 0.0,
    imu_gyro_noise: float = 0.0,
    vio_from_images: bool = False,
    frontend_cfg: V.FrontendConfig | None = None,
    sweep_stride: int = 4,
    generator: torch.Generator | None = None,
) -> VilScenario:
    """Build the ``town`` drive on ``device``. IMU noise needs a
    ``generator``.

    ``vio_from_images``: instead of synthetic feature tracks, render the
    camera frames and run the image tracker frontend (Shi-Tomasi + KLT +
    LiDAR feature depth) to produce the VIO frames. Needs ``vio_cfg.pose_ic``
    to be a real camera mounting (``frontend.forward_camera_extrinsics``);
    ``sweep_stride`` decimates the sweeps' azimuth for the depth
    association."""
    if kind != "town":
        raise ValueError(f"only the 'town' scenario is ported, got {kind!r}")
    if vio_cfg is None:
        vio_cfg = V.VioConfig()
    world = rc.town_world(n_boxes=28, seed=seed, dtype=dtype, device=device)
    traj = _town_traj()
    drive_speed = 4.0
    lm_extent, lm_height = 40.0, (0.5, 10.0)

    imu_t = (torch.arange(int(duration * imu_hz) + 20, dtype=dtype,
                          device=device) / imu_hz)
    imu = syn.sample_imu(traj, imu_t, accel_noise=imu_accel_noise,
                         gyro_noise=imu_gyro_noise, generator=generator)

    def poses_at(times: np.ndarray) -> torch.Tensor:
        return vmap(traj.pose_fn)(torch.as_tensor(times, dtype=dtype,
                                                  device=device))

    vio_times = (np.arange(int(duration * vio_hz)) + 1.0) / vio_hz
    poses_vio = poses_at(vio_times)
    imu_w = V.synthetic.imu_windows_for_frames(
        traj, vio_times, imu_hz=imu_hz, dtype=dtype, device=device)
    lidar_times = (np.arange(int(duration * lidar_hz)) + 1.0) / lidar_hz
    poses_lidar = poses_at(lidar_times)
    sweeps = rc.sweep_series(world, poses_lidar)

    images = pts_cam = sw_msk = None
    if vio_from_images:
        fcfg = frontend_cfg or V.FrontendConfig(cam=vio_cfg.cam)
        pose_ic = torch.tensor(vio_cfg.pose_ic, dtype=dtype, device=device)
        poses_cam = lie.pose_compose(poses_vio, pose_ic)
        images = rc.render_camera_series(world, poses_cam, vio_cfg.cam)
        pts_cam, sw_msk = _camera_sweeps(sweeps, lidar_times, vio_times,
                                         poses_cam, poses_lidar,
                                         sweep_stride)
        frames = V.frontend.build_frames(fcfg, images, pts_cam, sw_msk,
                                         imu_w, vio_cfg.num_landmarks)
    else:
        # Synthetic feature tracks over a field spanning the whole drive.
        span = drive_speed * duration
        n_lms = max(400, int(400 * (span / (2.0 * lm_extent) + 1.0)))
        lms = V.synthetic.landmark_field(n_lms, seed=seed + 1,
                                         extent=lm_extent, height=lm_height)
        lms[:, 0] = np.random.default_rng(seed + 3).uniform(
            -lm_extent, span + lm_extent, n_lms)
        frames = V.synthetic.make_frames(
            vio_cfg, poses_vio.cpu().numpy(), imu_w, lms, pixel_noise=0.5,
            depth_noise=0.05, seed=seed + 2)
    frames = _tree.tree_map(lambda x: x.to(dtype), frames)
    # Each sweep's prior = the VIO frame at the same time (vio_hz multiple).
    ratio = vio_hz / lidar_hz
    guess_idx = (np.round((np.arange(len(lidar_times)) + 1) * ratio) - 1
                 ).astype(np.int64)
    return VilScenario(
        traj=traj, world=world,
        imu_times=imu.times, imu_accel=imu.accel, imu_gyro=imu.gyro,
        vio_times=vio_times, vio_frames=frames,
        lidar_times=lidar_times, sweeps=sweeps, lidar_guess_idx=guess_idx,
        gt_vio_poses=poses_vio.cpu().numpy(),
        gt_lidar_poses=poses_lidar.cpu().numpy(),
        images=images, cam_points=pts_cam, cam_point_valid=sw_msk,
    )


def render_frontend_inputs(
    sc: VilScenario,
    cam,
    pose_ic,                       # (7,) imu_T_camera
    sweep_stride: int = 4,
    dtype=torch.float32,
):
    """Render the camera stream + per-frame camera-frame sweep points for an
    existing scenario (the ``vio_from_images`` inputs), on the device of
    the scenario's sweeps, one frame at a time.

    Returns (images (T,H,W), pts_cam (T,P,3), pt_valid (T,P))."""
    device = sc.sweeps.xyz.device
    poses_v = torch.as_tensor(sc.gt_vio_poses, dtype=dtype, device=device)
    poses_cam = lie.pose_compose(
        poses_v, torch.as_tensor(pose_ic, dtype=dtype, device=device))
    images = rc.render_camera_series(sc.world, poses_cam, cam)
    pts_cam, sw_msk = _camera_sweeps(
        sc.sweeps, np.asarray(sc.lidar_times), np.asarray(sc.vio_times),
        poses_cam, torch.as_tensor(sc.gt_lidar_poses, dtype=dtype,
                                   device=device), sweep_stride)
    return images.to(dtype), pts_cam.to(dtype), sw_msk.to(dtype)

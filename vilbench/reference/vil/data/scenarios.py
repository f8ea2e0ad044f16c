"""Full-system synthetic scenarios: one call builds everything a VIL run
needs from an analytic trajectory through a geometric world.

Port of ``vil_sensor_fusion_tpu/data/scenarios.py``: the ``town`` drive
(well conditioned), the ``corridor`` (translation-degenerate) and ``arena``
(rotation-degenerate) kinds, and the ``tunnel`` and ``field`` drives, which
enter and leave degeneracy mid-drive. Each is sampled into an IMU stream,
VIO frames, raycast VLP-16 sweeps (motion-distorted with
``distort_sweeps``), ground truth at the VIO and LiDAR event times, and the
labeled degenerate windows. The VIO frames are synthetic feature tracks by
default, or, with ``vio_from_images``, the image tracker's output on
rendered frames. The random worlds come from numpy's RNG (``raycast``).
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
    # Labeled degenerate time windows [(start_s, end_s, kind), ...] (the
    # DEGEN_TRANS / DEGEN_ROT dictionaries of make_prettier_graphs.py:46-120);
    # empty for well-conditioned scenarios.
    degen_windows: tuple = ()
    # Rendered frames (T_v, H, W) and the per-frame sweep points in the
    # camera frame + validity (T_v, P, 3) / (T_v, P), kept when
    # vio_from_images.
    images: object = None
    cam_points: object = None
    cam_point_valid: object = None


def _corridor_traj(speed: float = 4.0) -> syn.Trajectory:
    """Straight drive down the corridor (x axis) at sensor height 1.5 m."""
    def pos_fn(t):
        return torch.stack([speed * t, 0.05 * torch.sin(0.5 * t),
                            1.5 + 0.0 * t])

    def rot_fn(t):
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t,
                                        0.01 * torch.sin(0.3 * t)]))

    return syn.trajectory(pos_fn, rot_fn)


def _spin_traj(yaw_rate: float = 0.5) -> syn.Trajectory:
    """Rotate in place at the origin (sensor height 1.5 m) at a steady yaw
    rate."""
    def pos_fn(t):
        return torch.stack([0.0 * t, 0.0 * t, 1.5 + 0.0 * t])

    def rot_fn(t):
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t, yaw_rate * t]))

    return syn.trajectory(pos_fn, rot_fn)


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
    distort_sweeps: bool = False,
    generator: torch.Generator | None = None,
) -> VilScenario:
    """Build a drive of ``kind`` (town, corridor, arena, field, tunnel) on
    ``device``. IMU noise needs a ``generator``.

    ``distort_sweeps``: cast each sweep's azimuth columns from the sensor
    pose at their scan time and record them uncompensated
    (:func:`raycast.raycast_motion`), as a spinning LiDAR does.

    ``vio_from_images``: instead of synthetic feature tracks, render the
    camera frames and run the image tracker frontend (Shi-Tomasi + KLT +
    LiDAR feature depth) to produce the VIO frames. Needs ``vio_cfg.pose_ic``
    to be a real camera mounting (``frontend.forward_camera_extrinsics``);
    ``sweep_stride`` decimates the sweeps' azimuth for the depth
    association."""
    if vio_cfg is None:
        vio_cfg = V.VioConfig()
    world, traj, degen_windows, drive_speed, lm_extent, lm_height = _kind(
        kind, duration, seed, dtype, device)

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
    if distort_sweeps:
        poses_start = poses_at(lidar_times - 1.0 / lidar_hz)
        sw = [rc.raycast_motion(world, ps, pe)
              for ps, pe in zip(poses_start, poses_lidar)]
        sweeps = Sweep(*(torch.stack(f, dim=0) for f in zip(*sw)))
    else:
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
        degen_windows=degen_windows,
        images=images, cam_points=pts_cam, cam_point_valid=sw_msk,
    )


def _kind(kind: str, duration: float, seed: int, dtype, device):
    """(world, trajectory, labeled windows, drive speed, landmark extent,
    landmark heights) of a scenario kind."""
    degen_windows = ()
    drive_speed = 4.0               # sizes the VIO landmark field
    lm_extent, lm_height = 40.0, (0.5, 10.0)
    if kind == "corridor":
        world = rc.corridor_world(width=8.0, height=5.0, dtype=dtype,
                                  device=device)
        traj = _corridor_traj()
        lm_extent, lm_height = 30.0, (0.5, 4.5)
        degen_windows = ((0.0, duration, "trans"),)
    elif kind == "arena":
        # Spin at the centre of a surface of revolution: yaw unobservable
        # for ICP, translations well conditioned (DEGEN_ROT).
        world = rc.arena_world(radius=9.0, faces=96, dtype=dtype,
                               device=device)
        traj = _spin_traj()
        lm_extent, lm_height = 12.0, (0.5, 4.5)
        degen_windows = ((0.0, duration, "rot"),)
        drive_speed = 0.0
    elif kind == "town":
        world = rc.town_world(n_boxes=28, seed=seed, dtype=dtype,
                              device=device)
        traj = _town_traj()
    elif kind == "field":
        # Road drive whose middle third is open field, at motorcycle speed.
        # Translation starves once the nearest structure is ~25 m away; yaw
        # information is lever-arm weighted, so only the stretch with
        # ≥ ~110 m of clearance is labeled rot-degenerate, inside the trans
        # window.
        speed = 16.0
        drive_speed = speed
        length = speed * duration
        x0, x1 = length / 3.0, length * 2.0 / 3.0
        world = rc.field_world(x0=x0, x1=x1, length=length, seed=seed,
                               dtype=dtype, device=device)
        traj = _town_traj(speed=speed)
        transit_half = (x1 - x0) / speed / 2.0
        m_trans = min(25.0 / speed, transit_half)
        m_rot = max(m_trans,
                    min(110.0 / speed, max(transit_half - 0.5, 0.0)))
        degen_windows = (
            (x0 / speed + m_trans, x1 / speed - m_trans, "trans"),
            (x0 / speed + m_rot, x1 / speed - m_rot, "rot"),
        )
    elif kind == "tunnel":
        # A town-like road drive through a mid-drive tunnel capped at 40 m
        # (the reference's tunnels are portal-visible), labeled inside the
        # tube with half a sweep of margin at each portal, clamped to the
        # transit time.
        speed = 4.0
        length = speed * duration
        tunnel_len = min(length / 3.0, 40.0)
        x0 = length / 2.0 - tunnel_len / 2.0
        x1 = length / 2.0 + tunnel_len / 2.0
        world = rc.tunnel_world(x0=x0, x1=x1, width=8.0, height=5.0,
                                n_boxes=28, seed=seed, road_length=length,
                                dtype=dtype, device=device)
        traj = _corridor_traj(speed=speed)
        margin = min(0.5, (x1 - x0) / speed / 2.0)
        degen_windows = ((x0 / speed + margin, x1 / speed - margin,
                          "trans"),)
    else:
        raise ValueError(kind)
    return world, traj, degen_windows, drive_speed, lm_extent, lm_height


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

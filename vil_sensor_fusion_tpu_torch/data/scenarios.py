"""Full-system synthetic scenario: the ``town`` drive.

Port of the ``town`` case of ``vil_sensor_fusion_tpu/data/scenarios.py``:
an analytic trajectory through a box town, sampled into an IMU stream,
raycast VLP-16 sweeps and ground truth at the VIO and LiDAR event times.
There are no VIO frames yet (the VIO front-end is not ported); callers make
a VIO odometry stand-in with ``synthetic.sample_odometry``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..core import lie
from ..frontends.lidar.rangeimage import Sweep
from . import raycast as rc
from . import synthetic as syn


class VilScenario(NamedTuple):
    traj: syn.Trajectory
    world: rc.World
    imu_times: torch.Tensor
    imu_accel: torch.Tensor
    imu_gyro: torch.Tensor
    vio_times: np.ndarray
    lidar_times: np.ndarray
    sweeps: Sweep                   # stacked (T_l, R, A, ·)
    lidar_guess_idx: np.ndarray     # vio frame index per sweep
    gt_vio_poses: np.ndarray
    gt_lidar_poses: np.ndarray


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


def build(
    kind: str = "town",
    duration: float = 4.0,
    vio_hz: float = 20.0,
    lidar_hz: float = 10.0,
    imu_hz: float = 200.0,
    dtype=torch.float32,
    device=None,
    seed: int = 0,
    imu_accel_noise: float = 0.0,
    imu_gyro_noise: float = 0.0,
    generator: torch.Generator | None = None,
) -> VilScenario:
    """Build the ``town`` drive on ``device``. IMU noise needs a
    ``generator``."""
    if kind != "town":
        raise ValueError(f"only the 'town' scenario is ported, got {kind!r}")
    world = rc.town_world(n_boxes=28, seed=seed, dtype=dtype, device=device)
    traj = _town_traj()

    imu_t = (torch.arange(int(duration * imu_hz) + 20, dtype=dtype,
                          device=device) / imu_hz)
    imu = syn.sample_imu(traj, imu_t, accel_noise=imu_accel_noise,
                         gyro_noise=imu_gyro_noise, generator=generator)

    def poses_at(times: np.ndarray) -> torch.Tensor:
        return vmap(traj.pose_fn)(torch.as_tensor(times, dtype=dtype,
                                                  device=device))

    vio_times = (np.arange(int(duration * vio_hz)) + 1.0) / vio_hz
    lidar_times = (np.arange(int(duration * lidar_hz)) + 1.0) / lidar_hz
    poses_lidar = poses_at(lidar_times)
    sweeps = rc.sweep_series(world, poses_lidar)
    # Each sweep's prior = the VIO frame at the same time (vio_hz multiple).
    ratio = vio_hz / lidar_hz
    guess_idx = (np.round((np.arange(len(lidar_times)) + 1) * ratio) - 1
                 ).astype(np.int64)
    return VilScenario(
        traj=traj, world=world,
        imu_times=imu.times, imu_accel=imu.accel, imu_gyro=imu.gyro,
        vio_times=vio_times, lidar_times=lidar_times, sweeps=sweeps,
        lidar_guess_idx=guess_idx,
        gt_vio_poses=poses_at(vio_times).cpu().numpy(),
        gt_lidar_poses=poses_lidar.cpu().numpy(),
    )

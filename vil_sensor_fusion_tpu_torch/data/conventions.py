"""Frame-convention adapters and stream preprocessors on tensors.

Port of ``vil_sensor_fusion_tpu/data/conventions.py`` (the reference's L2
layer):

- the four coordinate conventions and their rotations
  (carla_tools/src/transform_helper.py:7-45): Carla (x fwd, y right, z up —
  left-handed), ROS (x fwd, y left, z up), ROVIO/camera (x right, y down,
  z fwd), LOAM (x left, y up, z fwd), Velodyne;
- IMU stream rotation incl. covariances (transform_helper.transform_imu:52-83);
- point-cloud rotation (transform_pointcloud2:85-97);
- the LOAM→ROS cyclic axis swap xyz→zxy of odometry
  (loam_frame_transform.loam_odom_callback_2:51-117);
- channel/horizontal point-cloud decimation, e.g. HDL-64E→VLP-16
  (downsample_pointcloud.py:43-62);
- 180° image flip for upside-down cameras (imgflip.py:22-32);
- color→mono conversion (the reference's image_proc dependency);
- moving-average IMU low-pass (imu_filter.py:30-52).

The convention rotations are float64 numpy constants; the functions take
them (or any 3×3 array or tensor) and apply them on the device and in the
dtype of the data. All functions are batched over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lie

# Rotation matrices between conventions (right-multiply column vectors):
# v_ros = ROS_FROM_LOAM @ v_loam, etc.
# ros_to_loam (transform_helper.py:27-32, then inverted at :43): LOAM axes in
# ROS coords are x_loam = y_ros, y_loam = z_ros, z_loam = x_ros.
ROS_FROM_LOAM = np.array([
    [0.0, 0.0, 1.0],
    [1.0, 0.0, 0.0],
    [0.0, 1.0, 0.0],
])
LOAM_FROM_ROS = ROS_FROM_LOAM.T
# ros_to_velodyne (transform_helper.py:34-39, inverted at :44).
ROS_FROM_VELODYNE = np.array([
    [0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0],
    [0.0, 0.0, 1.0],
])
VELODYNE_FROM_ROS = ROS_FROM_VELODYNE.T
# Camera/ROVIO convention: x right, y down, z fwd (transform_helper.py:20-25).
ROS_FROM_CAMERA = np.array([
    [0.0, 0.0, 1.0],
    [-1.0, 0.0, 0.0],
    [0.0, -1.0, 0.0],
])
CAMERA_FROM_ROS = ROS_FROM_CAMERA.T
# Carla → ROS: the reference treats positions as-is (carla_to_ros is the
# identity, transform_helper.py:6-11) and handles handedness per-field.
ROS_FROM_CARLA = np.eye(3)


def _like(R, v: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(R, dtype=v.dtype, device=v.device)


def rotate_vectors(R, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by a 3×3 convention rotation."""
    return torch.einsum("ij,...j->...i", _like(R, v), v)


def rotate_covariance(R, cov: torch.Tensor) -> torch.Tensor:
    """R Σ Rᵀ over (..., 3, 3) blocks (transform_covariance:47-49)."""
    R = _like(R, cov)
    return torch.einsum("ij,...jk,lk->...il", R, cov, R)


def transform_imu_stream(
    R,
    accel: torch.Tensor,
    gyro: torch.Tensor,
    accel_cov: torch.Tensor | None = None,
    gyro_cov: torch.Tensor | None = None,
):
    """Rotate an IMU stream between conventions (transform_imu semantics:
    rotate accel, gyro, and their covariances)."""
    out = [rotate_vectors(R, accel), rotate_vectors(R, gyro)]
    if accel_cov is not None:
        out.append(rotate_covariance(R, accel_cov))
    if gyro_cov is not None:
        out.append(rotate_covariance(R, gyro_cov))
    return tuple(out)


def transform_points(R, pts: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) point clouds (transform_pointcloud2 semantics)."""
    return rotate_vectors(R, pts)


def loam_odom_to_ros(poses: torch.Tensor) -> torch.Tensor:
    """The LOAM frame transform node's cyclic swap (x,y,z) ← (z,x,y) applied
    to both position and the quaternion's vector part
    (loam_frame_transform.py:51-117)."""
    q = lie.pose_quat(poses)
    t = lie.pose_trans(poses)
    t2 = torch.stack([t[..., 2], t[..., 0], t[..., 1]], dim=-1)
    q2 = torch.stack([q[..., 0], q[..., 3], q[..., 1], q[..., 2]], dim=-1)
    return lie.pose_make(q2, t2)


def downsample_cloud(
    points: torch.Tensor,
    channels: int,
    vert_downsample: int = 1,
    horiz_downsample: int = 1,
    rings_major: bool = False,
) -> torch.Tensor:
    """Channel/horizontal decimation of an ordered cloud (N, D) — the
    KITTI HDL-64E → VLP-16 conversion (downsample_pointcloud.py:43-62:
    vert 4×, horiz 2×). ``rings_major`` mirrors the node's `transpose` flag
    (input laid out rings-major vs. points-major)."""
    D = points.shape[-1]
    n = (points.shape[0] // channels) * channels
    p = points[:n]
    if rings_major:
        grid = p.reshape(-1, channels, D).permute(1, 0, 2)
    else:
        grid = p.reshape(channels, -1, D)
    return grid[::vert_downsample, ::horiz_downsample].reshape(-1, D)


def flip_image(img: torch.Tensor) -> torch.Tensor:
    """180° rotation for upside-down cameras (imgflip.py:22-32)."""
    return torch.flip(img, dims=(-2, -1))


def rgb_to_mono(img: torch.Tensor) -> torch.Tensor:
    """Color→mono (the image_proc dependency, vil_fusion.launch:33-34) with
    the standard BT.601 luma weights; an integer image is rounded back to
    its type."""
    floating = img.is_floating_point()
    w = torch.tensor([0.299, 0.587, 0.114],
                     dtype=img.dtype if floating else torch.float32,
                     device=img.device)
    mono = torch.einsum("...c,c->...", img.to(w.dtype), w)
    if floating:
        return mono
    return torch.clamp(torch.round(mono), 0, 255).to(img.dtype)


def imu_moving_average(
    accel: torch.Tensor,
    gyro: torch.Tensor,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Trailing moving average over the last `window` samples — the
    reference's IMU low-pass node (imu_filter.py:30-52); the first samples
    repeat the first value before the stream."""
    def avg(x):
        pad = torch.cat([x[:1].expand(window - 1, *x.shape[1:]), x], dim=0)
        return (pad.unfold(0, window, 1) * (1.0 / window)).sum(-1)

    return avg(accel), avg(gyro)

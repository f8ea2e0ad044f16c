"""Bag → pipeline-tensor ingestion: the bridge from recorded raw sensors to
the front-ends.

Port of ``vil_sensor_fusion_tpu/data/ingest.py``. The reference replays
bags through a subscriber graph (gtsam_fusion/launch/fusion_carla.launch:
13-97: rosbag play → image_proc → LOAM → ROVIO → fusion). Here ingestion
happens once: the native reader decodes every message on the host, every
PointCloud2 becomes an organized range-image :class:`Sweep` on the device
(``frontends.lidar.rangeimage.organize``, all sweeps in one batched call),
every Image a grayscale float frame (image_proc's color→mono), and the IMU
stream is cut into static-shape per-frame windows on the host and moved
over once.

Times are re-based to the bag's first IMU stamp in float64 on the host
before anything becomes float32: absolute ROS epochs (~1.7e9 s) are not
representable in f32, and the estimator only consumes time differences.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..frontends.lidar import rangeimage as RI
from . import conventions as CV
from .rosbag_io import BagReader


class BagArrays(NamedTuple):
    """One bag's raw-sensor content as pipeline arrays (times re-based)."""

    t0: float                      # subtracted epoch (first IMU stamp)
    imu_times: np.ndarray          # (N,)
    imu_accel: np.ndarray          # (N, 3)
    imu_gyro: np.ndarray           # (N, 3)
    lidar_times: np.ndarray        # (T_l,)
    sweeps: RI.Sweep               # stacked (T_l, R, A, ·), on the device
    cam_times: np.ndarray          # (T_c,)
    images: np.ndarray             # (T_c, H, W) float32 grayscale
    gt_times: np.ndarray | None = None
    gt_poses: np.ndarray | None = None   # (T_g, 7)


def load_sweeps(
    bag: BagReader,
    topic: str,
    rings: int = RI.RINGS,
    azimuth: int = RI.AZIMUTH,
    max_sweeps: int | None = None,
    max_points: int = 1 << 20,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> tuple[np.ndarray, RI.Sweep]:
    """Read every PointCloud2 on ``topic`` and organize each into the
    (R, A) grid on ``device``. Clouds are padded with (0, 0, 0) invalid
    points to the largest cloud."""
    n = bag.count(topic)
    if max_sweeps is not None:
        n = min(n, max_sweeps)
    stamps = np.zeros(n)
    clouds = []
    for i in range(n):
        stamps[i], xyz = bag.read_pointcloud(topic, i, max_points=max_points)
        clouds.append(xyz)
    if not clouds:
        raise IOError(f"no PointCloud2 messages on {topic!r}")
    P = max(len(c) for c in clouds)
    pts = np.zeros((n, P, 3), np.float32)
    val = np.zeros((n, P), np.float32)
    for i, c in enumerate(clouds):
        pts[i, : len(c)] = c
        val[i, : len(c)] = 1.0
    sweeps = RI.organize(torch.as_tensor(pts, dtype=dtype, device=device),
                         torch.as_tensor(val, dtype=dtype, device=device),
                         rings=rings, azimuth=azimuth)
    return stamps, sweeps


def load_images(
    bag: BagReader,
    topic: str,
    max_images: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Read every Image on ``topic`` → (stamps, (T, H, W) float32 mono) on
    the host. rgb8/bgr8 are converted with the image_proc luma weights
    (``data.conventions.rgb_to_mono``)."""
    n = bag.count(topic)
    if max_images is not None:
        n = min(n, max_images)
    stamps = np.zeros(n)
    frames = []
    for i in range(n):
        stamps[i], img, enc = bag.read_image(topic, i)
        if img.ndim == 3 and img.shape[2] >= 3:
            rgb = img[..., :3].astype(np.float32)
            if enc.startswith("bgr"):
                rgb = rgb[..., ::-1]
            img = CV.rgb_to_mono(torch.from_numpy(rgb.copy())).numpy()
        frames.append(np.asarray(img, np.float32))
    if not frames:
        raise IOError(f"no Image messages on {topic!r}")
    return stamps, np.stack(frames)


def imu_windows_from_stream(
    imu_t: np.ndarray,
    accel: np.ndarray,
    gyro: np.ndarray,
    frame_times: np.ndarray,
    start_time: float = 0.0,
    max_per_window: int | None = None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cut a recorded IMU stream into static-shape per-frame windows
    (accel (T, N, 3), gyro (T, N, 3), dts (T, N)) — window t covers
    (frame_{t-1}, frame_t], replicating IMUManager's window extraction
    (gtsam_fusion/src/gtsam_fusion/IMUManager.cpp:35-66). dts=0 rows are
    masked padding; the trailing dt closes the window exactly at frame_t.
    Built in float64 numpy on the host, then moved to ``device`` once."""
    T = len(frame_times)
    bounds = np.concatenate([[start_time], frame_times])
    idx_lo = np.searchsorted(imu_t, bounds[:-1], side="right")
    idx_hi = np.searchsorted(imu_t, bounds[1:], side="right")
    N = int(max(1, (idx_hi - idx_lo).max() + 1))
    if max_per_window is not None:
        N = min(N, max_per_window)
    a = np.zeros((T, N, 3))
    g = np.zeros((T, N, 3))
    dts = np.zeros((T, N))
    for t in range(T):
        lo, hi = idx_lo[t], idx_hi[t]
        ts = imu_t[lo:hi]
        n = len(ts)
        if n > N - 1:           # decimate pathological windows
            keep = np.linspace(0, n - 1, N - 1).round().astype(int)
            ts = ts[keep]
            a[t, : N - 1] = accel[lo:hi][keep]
            g[t, : N - 1] = gyro[lo:hi][keep]
            n = N - 1
        else:
            a[t, :n] = accel[lo:hi]
            g[t, :n] = gyro[lo:hi]
        prev = np.concatenate([[bounds[t]], ts[:-1]]) if n else ts
        dts[t, :n] = ts - prev
        # Close the window at frame_t with a zero-order hold of the last
        # sample (IMUManager.cpp:57-66's end interpolation).
        rem = bounds[t + 1] - (ts[-1] if n else bounds[t])
        if rem > 1e-9 and n < N:
            src = hi - 1 if hi > lo else min(lo, len(imu_t) - 1)
            a[t, n] = accel[src]
            g[t, n] = gyro[src]
            dts[t, n] = rem
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (a, g, dts))


def load_bag(
    path,
    imu_topic: str = "/imu/fusion",
    lidar_topic: str = "/lidar",
    camera_topic: str = "/cam_forward/image_raw",
    gt_topic: str | None = None,
    rings: int = RI.RINGS,
    azimuth: int = RI.AZIMUTH,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> BagArrays:
    """One-call ingestion of a raw-sensor bag (the fusion_carla.launch input
    surface: IMU + PointCloud2 + Image [+ GT odometry]); the sweeps land on
    ``device``, the other streams stay float64 / float32 numpy."""
    with BagReader(path) as bag:
        imu_t, accel, gyro = bag.read_imu(imu_topic)
        if len(imu_t) == 0:
            raise IOError(f"no Imu messages on {imu_topic!r}")
        t0 = float(imu_t[0])
        lt, sweeps = load_sweeps(bag, lidar_topic, rings=rings,
                                 azimuth=azimuth, dtype=dtype, device=device)
        ct, images = load_images(bag, camera_topic)
        gt_t = gt_p = None
        if gt_topic:
            gt_t, gt_p, _, _ = bag.read_odometry(gt_topic)
            gt_t = gt_t - t0
    return BagArrays(
        t0=t0,
        imu_times=imu_t - t0, imu_accel=accel, imu_gyro=gyro,
        lidar_times=lt - t0, sweeps=sweeps,
        cam_times=ct - t0, images=images,
        gt_times=gt_t, gt_poses=gt_p,
    )

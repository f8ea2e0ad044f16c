"""Synthetic feature tracks for VIO tests and the default scenario: a field
of world landmarks projected through the camera along a trajectory, with a
greedy host-side slot assignment standing in for the tracker.

Port of ``vil_sensor_fusion_tpu/frontends/vio/synthetic.py``. The noise
comes from ``numpy.random.default_rng(seed)`` as in JAX, so the same seed
gives the same tracks.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import DEFAULT_DEVICE
from ...core import lie
from . import camera as C
from . import ekf as E
from .pipeline import VioFrameInput


def landmark_field(n: int, seed: int = 0, extent: float = 40.0,
                   height: tuple = (0.0, 10.0)) -> np.ndarray:
    """Random world landmarks scattered around the origin."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-extent, extent, (n, 2))
    z = rng.uniform(height[0], height[1], (n,))
    return np.concatenate([xy, z[:, None]], axis=-1)


def make_frames(
    cfg: E.VioConfig,
    poses: np.ndarray,        # (T, 7) world_T_imu ground truth per frame
    imu_windows,              # (accel (T,N,3), gyro (T,N,3), dts (T,N))
    landmarks: np.ndarray,    # (L, 3) world landmark field
    pixel_noise: float = 0.5,
    depth_noise: float = 0.05,
    seed: int = 0,
) -> VioFrameInput:
    """Host-side generation of the full frame stream with a greedy tracker:
    each of the M slots tracks one world landmark; when it leaves the view,
    the slot is re-initialized with the most central visible untracked one
    (pixel + LiDAR-like depth). Projection runs in float64 on the CPU; the
    tracks come back as float64 tensors on the IMU windows' device."""
    rng = np.random.default_rng(seed)
    cam = cfg.cam
    M = cfg.num_landmarks
    T = poses.shape[0]
    L = landmarks.shape[0]
    lms = torch.as_tensor(np.asarray(landmarks, np.float64))
    pose_ic = torch.tensor(cfg.pose_ic, dtype=torch.float64)
    pose_wc = lie.pose_compose(torch.tensor(np.asarray(poses, np.float64)),
                               pose_ic)                       # (T, 7)
    p_cam = lie.quat_rotate(
        lie.quat_conjugate(lie.pose_quat(pose_wc))[:, None],
        lms[None] - lie.pose_trans(pose_wc)[:, None])         # (T, L, 3)
    uv_all, ok_all = C.project(cam, p_cam)
    uv_all, ok_all = uv_all.numpy(), ok_all.numpy()
    depth_all = p_cam[..., 2].numpy()

    slot_lm = -np.ones(M, np.int64)       # which world landmark each slot tracks
    obs_uv = np.zeros((T, M, 2))
    obs_valid = np.zeros((T, M))
    obs_depth = np.zeros((T, M))
    new_uv = np.zeros((T, M, 2))
    new_depth = np.ones((T, M))
    new_enable = np.zeros((T, M))

    for t in range(T):
        uv, ok, depth = uv_all[t], ok_all[t], depth_all[t]
        # Track continuing slots.
        for m in range(M):
            lm = slot_lm[m]
            if lm >= 0 and ok[lm]:
                obs_uv[t, m] = uv[lm] + pixel_noise * rng.standard_normal(2)
                obs_valid[t, m] = 1.0
                obs_depth[t, m] = max(
                    depth[lm] + depth_noise * rng.standard_normal(), 0.3)
            else:
                slot_lm[m] = -1
        # Replenish dead slots with the most central visible untracked lm.
        tracked = set(slot_lm[slot_lm >= 0].tolist())
        c = np.array([cam.cx, cam.cy])
        cand = [(np.linalg.norm(uv[l] - c), l)
                for l in range(L) if ok[l] and l not in tracked]
        cand.sort()
        ci = 0
        for m in range(M):
            if slot_lm[m] < 0 and ci < len(cand):
                l = cand[ci][1]
                ci += 1
                slot_lm[m] = l
                new_uv[t, m] = uv[l] + pixel_noise * rng.standard_normal(2)
                new_depth[t, m] = max(
                    depth[l] + depth_noise * rng.standard_normal(), 0.3)
                new_enable[t, m] = 1.0

    accel, gyro, dts = imu_windows
    dev = accel.device

    def t_(x):
        return torch.as_tensor(x, device=dev)

    return VioFrameInput(
        accel=accel, gyro=gyro, dts=dts,
        obs_uv=t_(obs_uv), obs_valid=t_(obs_valid), obs_depth=t_(obs_depth),
        new_uv=t_(new_uv), new_depth=t_(new_depth),
        new_enable=t_(new_enable),
    )


def imu_windows_for_frames(traj, frame_times: np.ndarray, imu_hz: float,
                           dtype=torch.float64, t_start: float = 0.0,
                           device=DEFAULT_DEVICE, **imu_kwargs):
    """Sample per-frame IMU windows from an analytic trajectory: window t
    covers (frame_{t-1}, frame_t] at the IMU rate; the clamped tail repeats
    the frame time with dt 0 (masked downstream). ``t_start`` is the time
    the first window opens at (set it for a mid-drive chunk)."""
    from ...data import synthetic as syn

    T = len(frame_times)
    frame_times = np.asarray(frame_times, np.float64)
    t0s = np.concatenate([[t_start], frame_times[:-1]])
    dt_frame = frame_times - t0s
    n_per = int(np.ceil(dt_frame.max() * imu_hz)) + 1
    k = np.arange(1, n_per + 1)
    ts = np.minimum(t0s[:, None] + k[None, :] / imu_hz,
                    frame_times[:, None])               # (T, n_per)
    prev = np.concatenate([t0s[:, None], ts[:, :-1]], axis=1)
    dts = ts - prev
    stream = syn.sample_imu(
        traj, torch.as_tensor(ts.reshape(-1), dtype=dtype, device=device),
        **imu_kwargs)
    return (stream.accel.reshape(T, n_per, 3), stream.gyro.reshape(T, n_per, 3),
            torch.as_tensor(dts, dtype=dtype, device=device))

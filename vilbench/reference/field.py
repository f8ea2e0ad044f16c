"""The inputs of the ``field-exp`` cell, on the frozen copy ``vil``: a
stretch of the thesis's field drive, the grid's only drive labelled
degenerate in rotation and in translation at once.

:func:`stretch` is :func:`experiment.tunnel_stretch`'s sampling with the
drive's kind as an argument: ``data/scenarios.build``'s drive of
``DRIVE_S`` seconds (its world, trajectory, labels and rates unchanged),
sampled over ``[start_s, start_s + duration_s]`` only and put on the
stretch's own clock, which starts at 0 at ``start_s``. :func:`field_stretch`
is its field case. The composition and the scoring are
``experiment.run_scenario`` and ``experiment.experiment_config``, unchanged.
``experiment.tunnel_stretch`` is the tunnel case of :func:`stretch`, written
out; a change to the benchmark's existing files can make it a call of this
one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from . import experiment as X
from .vil import _tree
from .vil.data import raycast as rc
from .vil.data import scenarios
from .vil.data import synthetic as syn
from .vil.frontends import lidar as L
from .vil.frontends import vio as V

KIND = "field"


def stretch(kind: str, seed: int, start_s: float, duration_s: float,
            device, dtype=torch.float32) -> scenarios.VilScenario:
    """``scenarios.build(kind, duration=DRIVE_S, seed=seed,
    distort_sweeps=True)`` with the experiment's VIO, from drive time
    ``start_s`` for ``duration_s`` seconds, on the stretch's clock.

    The world, the trajectory and the labelled windows are those of the
    whole drive (the windows shifted by ``-start_s``). The IMU stream, the
    VIO frames' IMU windows, the frame and sweep times, the
    motion-distorted sweeps and the ground truth are ``build``'s sampling
    of a drive of ``duration_s`` on the shifted trajectory. The synthetic
    landmarks follow ``build``'s rule over the stretch: ``max(400, 400 ·
    (span / 2·extent + 1))`` of them, their x uniform over the stretch's
    road ± extent, from the same seeds."""
    world, traj, windows, speed, extent, height = scenarios._kind(
        kind, X.DRIVE_S, seed, dtype, device)
    traj = X._shifted(traj, start_s)
    vio_cfg = X.experiment_config().vio

    imu_t = (torch.arange(int(duration_s * X.IMU_HZ) + 20, dtype=dtype,
                          device=device) / X.IMU_HZ)
    imu = syn.sample_imu(traj, imu_t)

    def poses_at(times):
        return vmap(traj.pose_fn)(torch.as_tensor(times, dtype=dtype,
                                                  device=device))

    vio_times = (np.arange(int(duration_s * X.VIO_HZ)) + 1.0) / X.VIO_HZ
    poses_vio = poses_at(vio_times)
    imu_w = V.synthetic.imu_windows_for_frames(
        traj, vio_times, imu_hz=X.IMU_HZ, dtype=dtype, device=device)
    lidar_times = (np.arange(int(duration_s * X.LIDAR_HZ)) + 1.0) \
        / X.LIDAR_HZ
    poses_lidar = poses_at(lidar_times)
    poses_start = poses_at(lidar_times - 1.0 / X.LIDAR_HZ)
    sw = [rc.raycast_motion(world, ps, pe)
          for ps, pe in zip(poses_start, poses_lidar)]
    sweeps = L.Sweep(*(torch.stack(f, dim=0) for f in zip(*sw)))

    span = speed * duration_s
    x_start = speed * start_s
    n_lms = max(400, int(400 * (span / (2.0 * extent) + 1.0)))
    lms = V.synthetic.landmark_field(n_lms, seed=seed + 1, extent=extent,
                                     height=height)
    lms[:, 0] = np.random.default_rng(seed + 3).uniform(
        x_start - extent, x_start + span + extent, n_lms)
    frames = V.synthetic.make_frames(
        vio_cfg, poses_vio.cpu().numpy(), imu_w, lms, pixel_noise=0.5,
        depth_noise=0.05, seed=seed + 2)
    frames = _tree.tree_map(lambda x: x.to(dtype), frames)
    ratio = X.VIO_HZ / X.LIDAR_HZ
    guess_idx = (np.round((np.arange(len(lidar_times)) + 1) * ratio) - 1
                 ).astype(np.int64)
    return scenarios.VilScenario(
        traj=traj, world=world,
        imu_times=imu.times, imu_accel=imu.accel, imu_gyro=imu.gyro,
        vio_times=vio_times, vio_frames=frames,
        lidar_times=lidar_times, sweeps=sweeps, lidar_guess_idx=guess_idx,
        gt_vio_poses=poses_vio.cpu().numpy(),
        gt_lidar_poses=poses_lidar.cpu().numpy(),
        degen_windows=tuple((a - start_s, b - start_s, k)
                            for a, b, k in windows))


def field_stretch(seed: int, start_s: float, duration_s: float, device,
                  dtype=torch.float32) -> scenarios.VilScenario:
    """:func:`stretch` of the field drive."""
    return stretch(KIND, seed, start_s, duration_s, device, dtype)

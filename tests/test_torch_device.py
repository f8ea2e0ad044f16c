"""The port's entry points put what they create on the card unless the
caller names the CPU: with the device argument left out, each one either
returns CUDA tensors or, on a host without CUDA, raises. None of them may
quietly land on the CPU."""

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import DEFAULT_DEVICE, _tree, convert
from vil_sensor_fusion_tpu_torch.core import lie
from vil_sensor_fusion_tpu_torch.data import raycast, scenarios
from vil_sensor_fusion_tpu_torch.frontends.lidar import odometry, voxelmap
from vil_sensor_fusion_tpu_torch.data import ingest
from vil_sensor_fusion_tpu_torch.frontends.lidar import rangeimage
from vil_sensor_fusion_tpu_torch.frontends.vio import (ekf, frontend,
                                                       photometric, synthetic)
from vil_sensor_fusion_tpu_torch.fusion import engine, vil
from vil_sensor_fusion_tpu_torch.graph import batch


def _photo_state():
    """photometric.init_photo of a state made with the identity pose left
    on its default device."""
    cfg = ekf.VioConfig(num_landmarks=2)
    zeros = lambda n: torch.zeros(n, device=DEFAULT_DEVICE)  # noqa: E731
    return photometric.init_photo(cfg, ekf.init(cfg, lie.pose_identity(),
                                                zeros(3), zeros(6)))


def _photo_inputs():
    """build_photo_inputs_from_bag on a 2-frame bag whose sweeps ingestion
    left on its default device (``ingest.load_bag``'s)."""
    z = lambda *shape: torch.zeros(shape, device=DEFAULT_DEVICE)  # noqa: E731
    cam = frontend.FrontendConfig().cam._replace(width=64, height=48)
    ba = ingest.BagArrays(
        t0=0.0, imu_times=np.arange(20) * 0.005, imu_accel=np.zeros((20, 3)),
        imu_gyro=np.zeros((20, 3)), lidar_times=np.array([0.05]),
        sweeps=rangeimage.Sweep(z(1, 4, 8, 3), z(1, 4, 8), z(1, 4, 8)),
        cam_times=np.array([0.05, 0.09]),
        images=np.zeros((2, 48, 64), np.float32))
    return vil.build_photo_inputs_from_bag(frontend.FrontendConfig(cam=cam),
                                           ba, ekf.VioConfig().pose_ic)


def _solve_batch():
    """graph.batch.solve_batch given numpy inputs only: one VIO event."""
    eye_cov = np.eye(6)[None] * 1e-2
    tl = engine.merge_timeline([(np.array([0.05]),
                                 np.array([[1.0, 0, 0, 0, 0, 0, 0]]),
                                 eye_cov, np.ones(1))])
    cfg = engine.FusionConfig(sensors=(engine.SensorSpec(name="vio"),))
    t = np.arange(20) * 0.005
    return batch.solve_batch(cfg, tl, t, np.tile([0.0, 0.0, 9.81], (20, 1)),
                             np.zeros((20, 3)), np.array([1.0, 0, 0, 0, 0,
                                                          0, 0]),
                             np.zeros(3), np.zeros(6), 0.0, iters=2)


ENTRY_POINTS = {
    "scenarios.build": lambda: scenarios.build("town", duration=0.2),
    "raycast.town_world": lambda: raycast.town_world(),
    "odometry.init": lambda: odometry.init(odometry.LidarOdomConfig()),
    "voxelmap.empty": lambda: voxelmap.empty(voxelmap.VoxelMapConfig()),
    "frontend.init_tracker": lambda: frontend.init_tracker(
        frontend.FrontendConfig(), 4),
    "frontend.forward_camera_extrinsics":
        lambda: frontend.forward_camera_extrinsics(),
    "synthetic.imu_windows_for_frames": lambda: (
        synthetic.imu_windows_for_frames(scenarios._town_traj(),
                                         np.array([0.05, 0.1]), 200.0)),
    "convert.to_torch": lambda: convert.to_torch(np.zeros(3)),
    "lie.quat_identity": lambda: lie.quat_identity(),
    "lie.pose_identity": lambda: lie.pose_identity(),
    "photometric.init_photo": _photo_state,
    "vil.build_photo_inputs_from_bag": _photo_inputs,
    "batch.solve_batch": _solve_batch,
}


def test_default_device_is_the_card():
    assert DEFAULT_DEVICE == torch.device("cuda")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_does_not_land_on_cpu(name):
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            ENTRY_POINTS[name]()
        return
    tensors = [x for x in _tree.tree_leaves(ENTRY_POINTS[name]())
               if isinstance(x, torch.Tensor)]
    assert tensors and all(t.is_cuda for t in tensors)


def test_town_scenario_on_cpu_when_asked():
    sc = scenarios.build("town", duration=0.2, device="cpu")
    assert sc.sweeps.xyz.device.type == "cpu"
    assert sc.imu_accel.device.type == "cpu"

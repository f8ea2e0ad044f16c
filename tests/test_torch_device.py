"""The port's entry points put what they create on the card unless the
caller names the CPU: with the device argument left out, each one either
returns CUDA tensors or, on a host without CUDA, raises. None of them may
quietly land on the CPU."""

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import DEFAULT_DEVICE, _tree, convert
from vil_sensor_fusion_tpu_torch.data import raycast, scenarios
from vil_sensor_fusion_tpu_torch.frontends.lidar import odometry, voxelmap
from vil_sensor_fusion_tpu_torch.frontends.vio import frontend, synthetic

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

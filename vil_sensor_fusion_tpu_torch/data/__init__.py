"""Synthetic data: analytic trajectories, raycast LiDAR, the town drive."""

from . import raycast, scenarios, synthetic
from .synthetic import (
    ImuStream,
    OdometryStream,
    Trajectory,
    sample_imu,
    sample_odometry,
    trajectory,
)

__all__ = [
    "raycast", "scenarios", "synthetic", "ImuStream", "OdometryStream",
    "Trajectory", "sample_imu", "sample_odometry", "trajectory",
]

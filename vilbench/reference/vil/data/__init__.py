"""Synthetic data: analytic trajectories, raycast LiDAR, the town drive."""

from . import raycast, scenarios, synthetic
from .synthetic import (
    GroundTruth,
    ImuStream,
    OdometryStream,
    Trajectory,
    circle,
    figure_eight,
    sample_ground_truth,
    sample_imu,
    sample_odometry,
    straight_tunnel,
    trajectory,
)

__all__ = [
    "raycast", "scenarios", "synthetic", "GroundTruth", "ImuStream",
    "OdometryStream", "Trajectory", "circle", "figure_eight",
    "sample_ground_truth", "sample_imu", "sample_odometry",
    "straight_tunnel", "trajectory",
]

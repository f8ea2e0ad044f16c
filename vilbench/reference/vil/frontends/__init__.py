"""Odometry front-ends: LiDAR (LOAM-equivalent) and VIO (ROVIO-equivalent)."""

from . import lidar
from . import vio

__all__ = ["lidar", "vio"]

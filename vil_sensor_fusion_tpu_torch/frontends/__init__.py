"""Odometry front-ends. Only the LiDAR front-end is ported so far."""

from . import lidar

__all__ = ["lidar"]

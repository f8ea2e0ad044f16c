"""LiDAR odometry front-end (LOAM-equivalent): curvature features,
scan-to-map ICP with explicit 6×6 Hessian, fixed-capacity voxel map."""

from . import features
from . import icp
from . import odometry
from . import rangeimage
from . import voxelmap
from .features import FeatureSet, extract
from .icp import IcpConfig, IcpResult, register
from .odometry import (
    LidarOdomConfig,
    LidarOdomResult,
    LidarOdomState,
    constant_velocity_guess,
)
from .rangeimage import AZIMUTH, RINGS, Sweep, organize, undistort
from .voxelmap import VoxelMap, VoxelMapConfig

__all__ = [
    "features", "icp", "odometry", "rangeimage", "voxelmap",
    "FeatureSet", "extract", "IcpConfig", "IcpResult", "register",
    "LidarOdomConfig", "LidarOdomResult", "LidarOdomState",
    "constant_velocity_guess", "AZIMUTH", "RINGS", "Sweep", "organize",
    "undistort", "VoxelMap", "VoxelMapConfig",
]

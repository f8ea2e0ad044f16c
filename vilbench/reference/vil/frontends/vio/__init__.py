"""Visual-inertial front-end (ROVIO-equivalent capability): error-state EKF
with landmark states, iterated camera updates, an image-driven tracker
frontend (Shi-Tomasi + pyramidal KLT), and LiDAR-provided feature depth
initialization (rovio.cfg useDepthFromLiDAR), and the direct photometric
mode (``photometric``: patch templates aligned inside the EKF update)."""

from . import camera
from . import ekf
from . import frontend
from . import pipeline
from . import synthetic
from . import tracker
from .camera import Camera, backproject, carla_camera, project
from .ekf import VioConfig, VioState, init, init_landmark, pose_covariance, propagate, update
from .frontend import FrontendConfig, build_frames, forward_camera_extrinsics
from .pipeline import VioFrameInput, VioOutput, run, step

__all__ = [
    "camera", "ekf", "frontend", "pipeline", "synthetic",
    "tracker",
    "Camera", "backproject", "carla_camera", "project",
    "VioConfig", "VioState", "init", "init_landmark", "pose_covariance",
    "propagate", "update", "VioFrameInput", "VioOutput", "run", "step",
    "FrontendConfig", "build_frames", "forward_camera_extrinsics",
]

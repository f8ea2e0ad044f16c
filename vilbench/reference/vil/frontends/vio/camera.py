"""Pinhole camera model.

Port of ``vil_sensor_fusion_tpu/frontends/vio/camera.py``. The reference's
rig: 800×600 RGB, fov 100° (carla_tools/config/sensors.json front camera).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 800
    height: int = 600


def carla_camera(width: int = 800, height: int = 600,
                 fov_deg: float = 100.0) -> Camera:
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    return Camera(fx=float(f), fy=float(f),
                  cx=width / 2.0, cy=height / 2.0,
                  width=width, height=height)


def project(cam: Camera, p_cam: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (…, 3) → pixel (…, 2), plus validity (z > 0.1,
    inside image). Camera frame: x right, y down, z forward."""
    z = p_cam[..., 2]
    eps = 1e-6
    zs = torch.where(torch.abs(z) < eps, eps, z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return torch.stack([u, v], dim=-1), ok


def backproject(cam: Camera, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixel + depth (along z) → camera-frame point."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    one = torch.ones_like(x)
    return torch.stack([x, y, one], dim=-1) * depth[..., None]

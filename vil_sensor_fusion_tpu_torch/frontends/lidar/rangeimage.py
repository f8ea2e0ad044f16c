"""Organized VLP-16 range image: the sweep layout and motion undistortion.

Port of ``vil_sensor_fusion_tpu/frontends/lidar/rangeimage.py``. A sweep is
stored as ``xyz`` (R, A, 3) points in the sensor frame, ``rng`` (R, A)
range (0 where invalid) and ``mask`` (R, A) validity. Azimuth column ``a``
covers angle ``2π·a/A − π``; rings are ordered by elevation.
``organize`` (bag ingestion) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core import lie

RINGS = 16
AZIMUTH = 1800   # 0.2° resolution at 10 Hz, the VLP-16's native resolution

# VLP-16 elevation angles, degrees (evenly spaced -15..15).
VLP16_ELEVATIONS_DEG = np.linspace(-15.0, 15.0, RINGS)


class Sweep(NamedTuple):
    xyz: torch.Tensor    # (R, A, 3)
    rng: torch.Tensor    # (R, A)
    mask: torch.Tensor   # (R, A) float 0/1


def undistort(
    sweep: Sweep,
    xi_motion: torch.Tensor,
    scan_period_fraction: torch.Tensor | None = None,
) -> Sweep:
    """Motion-compensate a sweep: column ``a`` was captured at fraction
    (a+0.5)/A of the scan, so its points are warped to the sweep-end frame
    by the remaining fraction of the end-from-start motion ``xi_motion``
    (se3 tangent)."""
    R, A, _ = sweep.xyz.shape
    if scan_period_fraction is None:
        frac = (torch.arange(A, dtype=sweep.xyz.dtype,
                             device=sweep.xyz.device) + 0.5) / A
    else:
        frac = scan_period_fraction
    alpha = (1.0 - frac)[None, :, None]                 # (1, A, 1)
    xi = xi_motion[None, None, :] * alpha               # (1, A, 6)
    pose = lie.se3_exp(xi)                              # (1, A, 7)
    pts = lie.quat_rotate(lie.pose_quat(pose), sweep.xyz) + lie.pose_trans(pose)
    return Sweep(xyz=pts * sweep.mask[..., None], rng=sweep.rng,
                 mask=sweep.mask)

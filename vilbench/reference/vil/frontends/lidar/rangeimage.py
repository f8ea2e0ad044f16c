"""Organized VLP-16 range image: the sweep layout, the organization of an
unordered cloud into it, and motion undistortion.

Port of ``vil_sensor_fusion_tpu/frontends/lidar/rangeimage.py``. A sweep is
stored as ``xyz`` (R, A, 3) points in the sensor frame, ``rng`` (R, A)
range (0 where invalid) and ``mask`` (R, A) validity. Azimuth column ``a``
covers angle ``2π·a/A − π``; rings are ordered by elevation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ... import _scatter
from ...core import lie

RINGS = 16
AZIMUTH = 1800   # 0.2° resolution at 10 Hz, the VLP-16's native resolution

# VLP-16 elevation angles, degrees (evenly spaced -15..15).
VLP16_ELEVATIONS_DEG = np.linspace(-15.0, 15.0, RINGS)


class Sweep(NamedTuple):
    xyz: torch.Tensor    # (R, A, 3)
    rng: torch.Tensor    # (R, A)
    mask: torch.Tensor   # (R, A) float 0/1


def organize(
    points: torch.Tensor,
    valid: torch.Tensor,
    rings: int = RINGS,
    azimuth: int = AZIMUTH,
    elev_min_deg: float = -15.0,
    elev_max_deg: float = 15.0,
) -> Sweep:
    """Scatter unordered (..., N, 3) clouds into (..., R, A) grids, one per
    leading index (``valid`` (..., N)).

    Ring index from elevation angle, azimuth bin from atan2 — the same
    assignment LOAM's MultiScanRegistration does per point. Collisions keep
    the nearer point (scatter-min on range).

    The JAX function writes the points with two scatters whose duplicate
    indices XLA applies in index order (the last update stays):
    1. every point writes its cell if it wins it (its range is the cell's
       minimum), else zeros into the last cell (R·A − 1);
    2. every point writes its cell again: its own point if it wins, else
       what step 1 left there.
    A CUDA scatter with duplicate indices picks any update, so here each
    step's surviving update is found explicitly (``_scatter.last_writer``). Equal-range winners of one cell keep the highest index, a
    loser written last into a cell keeps step 1's value, and the last
    cell's winner is lost (zero xyz under a set mask) when a loser of that
    cell comes after it: all as in JAX."""
    lead = points.shape[:-2]
    N = points.shape[-2]
    B = math.prod(lead)
    RA = rings * azimuth
    dtype, device = points.dtype, points.device
    pts = points.reshape(B * N, 3)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r_xy = torch.sqrt(x * x + y * y)
    rng = torch.sqrt(x * x + y * y + z * z)
    elev = torch.rad2deg(torch.atan2(z, r_xy))
    az = torch.atan2(y, x)  # [-π, π)

    ring_f = (elev - elev_min_deg) / (elev_max_deg - elev_min_deg) * (rings - 1)
    ring = torch.clamp(torch.round(ring_f).to(torch.int64), 0, rings - 1)
    col = torch.clamp(
        torch.floor((az + math.pi) / (2.0 * math.pi) * azimuth)
        .to(torch.int64), 0, azimuth - 1)

    ok = (valid.reshape(B * N) != 0) & (rng > 0.1)
    big = torch.tensor(1e9, dtype=dtype, device=device)
    base = torch.arange(B, device=device).repeat_interleave(N) * RA
    flat_idx = base + ring * azimuth + col

    # Scatter-min on range to resolve collisions (order-free).
    rng_grid = torch.full((B * RA,), 1e9, dtype=dtype, device=device)
    rng_grid = rng_grid.scatter_reduce(0, flat_idx, torch.where(ok, rng, big),
                                       reduce="amin")
    # A point wins its cell iff its range equals the cell minimum.
    win = ok & (rng == rng_grid[flat_idx])
    zero = torch.zeros((), dtype=dtype, device=device)
    # Step 1: winners to their cells, losers' zeros to their sweep's last cell.
    last1 = _scatter.last_writer(B * RA, torch.where(win, flat_idx, base + RA - 1))
    w1 = last1.clamp(min=0)
    grid1 = torch.where(((last1 >= 0) & win[w1])[:, None], pts[w1], zero)
    # Step 2: every point to its cell, a winner with its point.
    last2 = _scatter.last_writer(B * RA, flat_idx)
    w2 = last2.clamp(min=0)
    xyz_grid = torch.where(((last2 >= 0) & win[w2])[:, None], pts[w2], grid1)

    mask = (rng_grid < big).to(dtype)
    rng_out = torch.where(mask > 0, rng_grid, zero)
    return Sweep(
        xyz=xyz_grid.reshape(*lead, rings, azimuth, 3),
        rng=rng_out.reshape(*lead, rings, azimuth),
        mask=mask.reshape(*lead, rings, azimuth),
    )


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

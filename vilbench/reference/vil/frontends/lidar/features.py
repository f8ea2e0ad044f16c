"""LOAM-style curvature feature extraction, fully vectorized.

Port of ``vil_sensor_fusion_tpu/frontends/lidar/features.py``, with the
MultiScanRegistration settings of the reference (loam_params.yaml):
±5 ring neighbours in the curvature sum, 6 azimuth regions per ring,
top-2 sharp / top-20 less-sharp corners and top-4 flat points per region,
curvature threshold 0.1, and a strided less-flat subsample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rangeimage import Sweep

CURVATURE_REGION = 5     # neighbors each side
FEATURE_REGIONS = 6
MAX_SHARP = 2
MAX_LESS_SHARP = 20
MAX_FLAT = 4
CURV_THRESHOLD = 0.1
LESS_FLAT_STRIDE = 8


class FeatureSet(NamedTuple):
    """Fixed-size feature clouds in the sensor frame (points + 0/1 masks)."""

    sharp: torch.Tensor         # (Ns, 3) strongest corners
    sharp_mask: torch.Tensor    # (Ns,)
    less_sharp: torch.Tensor    # (Nl, 3) corner pool (matching targets)
    less_sharp_mask: torch.Tensor
    flat: torch.Tensor          # (Nf, 3) flattest surface points
    flat_mask: torch.Tensor
    less_flat: torch.Tensor     # (Np, 3) surface pool (matching targets)
    less_flat_mask: torch.Tensor


def pool_sizes(rings: int, azimuth: int) -> tuple[int, int]:
    """Static sizes of the (corner pool, surface pool) clouds extract()
    produces for an (R, A) sweep."""
    n_corner = rings * FEATURE_REGIONS * MAX_LESS_SHARP
    n_surf = (rings * FEATURE_REGIONS * MAX_FLAT
              + rings * ((azimuth + LESS_FLAT_STRIDE - 1)
                         // LESS_FLAT_STRIDE))
    return n_corner, n_surf


def curvature(sweep: Sweep) -> tuple[torch.Tensor, torch.Tensor]:
    """LOAM curvature c_i = ‖Σ_{k=±1..±K}(p_{i+k} − p_i)‖² per ring point,
    normalized by range². Returns (curv (R,A), valid (R,A)); valid requires
    the full ±K neighbourhood present."""
    K = CURVATURE_REGION
    xyz = sweep.xyz
    acc = torch.zeros_like(xyz)
    nvalid = torch.ones_like(sweep.mask)
    for k in range(1, K + 1):
        for s in (-k, k):
            acc = acc + torch.roll(xyz, s, dims=1) - xyz
            nvalid = nvalid * torch.roll(sweep.mask, s, dims=1)
    c = torch.sum(acc * acc, dim=-1)
    denom = torch.clamp(sweep.rng * sweep.rng, min=1e-6)
    valid = sweep.mask * nvalid
    return c / denom, valid


def _occlusion_mask(sweep: Sweep) -> torch.Tensor:
    """LOAM's two exclusion rules: the far side of a >0.3 m range jump to an
    azimuth neighbour, and near-parallel surfaces (both neighbour range
    differences above 2% of range)."""
    r = sweep.rng
    r_next = torch.roll(r, -1, dims=1)
    r_prev = torch.roll(r, 1, dims=1)
    m_next = torch.roll(sweep.mask, -1, dims=1)
    m_prev = torch.roll(sweep.mask, 1, dims=1)
    occl = (((r - r_next > 0.3) & (m_next > 0))
            | ((r - r_prev > 0.3) & (m_prev > 0)))
    par = (torch.abs(r_next - r) > 0.02 * r) & (torch.abs(r_prev - r) > 0.02 * r)
    return (~(occl | par)).to(r.dtype)


def _select_region_topk(
    score: torch.Tensor,     # (R, A) selection score (higher = better)
    ok: torch.Tensor,        # (R, A) eligibility
    k_per_region: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat grid indices (R·regions·k,) of the top-k eligible per region,
    and whether each pick is eligible.

    Ties resolve to the lowest column, as ``lax.top_k`` does: a stable
    descending sort keeps equal scores in index order (``torch.topk``
    promises no order among ties, and every ineligible entry ties at −inf)."""
    R, A = score.shape
    width = A // FEATURE_REGIONS
    reg = score.reshape(R, FEATURE_REGIONS, width)
    okr = ok.reshape(R, FEATURE_REGIONS, width)
    masked = torch.where(okr > 0, reg, -torch.inf)
    idx = torch.sort(masked, dim=-1, descending=True,
                     stable=True).indices[..., :k_per_region]
    col = idx + (torch.arange(FEATURE_REGIONS, device=score.device)
                 * width)[None, :, None]
    row = torch.arange(R, device=score.device)[:, None, None]
    flat = row * A + col
    picked_ok = torch.gather(okr, -1, idx) > 0
    return flat.reshape(-1), picked_ok.reshape(-1)


def extract(sweep: Sweep) -> FeatureSet:
    """Extract all four feature clouds from an organized sweep."""
    c, valid = curvature(sweep)
    keep = valid * _occlusion_mask(sweep)
    pts = sweep.xyz.reshape(-1, 3)

    corner_ok = (keep > 0) & (c > CURV_THRESHOLD)
    sharp_idx, sharp_ok = _select_region_topk(c, corner_ok, MAX_SHARP)
    ls_idx, ls_ok = _select_region_topk(c, corner_ok, MAX_LESS_SHARP)

    surf_ok = (keep > 0) & (c < CURV_THRESHOLD)
    flat_idx, flat_ok = _select_region_topk(-c, surf_ok, MAX_FLAT)

    dtype = sweep.xyz.dtype
    lf = sweep.xyz[:, ::LESS_FLAT_STRIDE, :].reshape(-1, 3)
    lf_ok = surf_ok[:, ::LESS_FLAT_STRIDE].reshape(-1)

    return FeatureSet(
        sharp=pts[sharp_idx],
        sharp_mask=sharp_ok.to(dtype),
        less_sharp=pts[ls_idx],
        less_sharp_mask=ls_ok.to(dtype),
        flat=pts[flat_idx],
        flat_mask=flat_ok.to(dtype),
        less_flat=lf,
        less_flat_mask=lf_ok.to(dtype),
    )

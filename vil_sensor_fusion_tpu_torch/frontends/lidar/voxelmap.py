"""Fixed-capacity voxel feature map.

Port of ``vil_sensor_fusion_tpu/frontends/lidar/voxelmap.py``: the exact
insert (packed voxel keys, stable argsort, first occurrence wins, nearest
``capacity`` kept), the O(N) hashed insert (an open-addressed spatial
hash), and the nearest-``budget`` submap. ``VoxelMapConfig.hashed`` picks
the insert (``insert_auto``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import DEFAULT_DEVICE, _scatter


class VoxelMapConfig(NamedTuple):
    capacity: int = 32768
    leaf: float = 0.4            # voxel edge (m)
    keep_radius: float = 120.0   # points beyond this of the sensor are evicted
    grid_half_extent: int = 512  # packed-key range of the exact insert
    hashed: bool = True


class VoxelMap(NamedTuple):
    points: torch.Tensor   # (C, 3)
    mask: torch.Tensor     # (C,)


def empty(cfg: VoxelMapConfig, dtype=torch.float32,
          device=DEFAULT_DEVICE) -> VoxelMap:
    return VoxelMap(
        points=torch.zeros((cfg.capacity, 3), dtype=dtype, device=device),
        mask=torch.zeros((cfg.capacity,), dtype=dtype, device=device),
    )


def _voxel_keys(pts: torch.Tensor, center: torch.Tensor,
                cfg: VoxelMapConfig) -> torch.Tensor:
    """Exact packed int32 voxel key relative to ``center`` (no collisions
    within ±half_extent·leaf of the sensor; outside, coordinates clamp and
    merge — those points are beyond keep_radius anyway)."""
    H = cfg.grid_half_extent
    g = torch.floor((pts - center[None, :]) / cfg.leaf).to(torch.int32)
    g = torch.clamp(g, -H, H - 1) + H
    return (g[:, 0] * (2 * H) + g[:, 1]) * (2 * H) + g[:, 2]


def _top(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, ties (the many −inf) to the lowest
    index first — a stable descending sort (``torch.topk`` promises no
    order among ties)."""
    top, idx = torch.sort(score, descending=True, stable=True)
    return top[:k], idx[:k]


def insert(
    m: VoxelMap,
    new_pts: torch.Tensor,
    new_mask: torch.Tensor,
    center: torch.Tensor,
    cfg: VoxelMapConfig,
) -> VoxelMap:
    """Merge new points into the map: voxel-dedup (old points win their
    voxel, as LOAM's map absorbs the scan after its own downsample), then
    keep the ``capacity`` nearest-to-sensor survivors."""
    dtype = m.points.dtype
    C = cfg.capacity
    pts = torch.cat([m.points, new_pts.to(dtype)], dim=0)
    ok = torch.cat([m.mask, new_mask.to(dtype)], dim=0)
    N = pts.shape[0]

    keys = _voxel_keys(pts, center, cfg)
    # Invalid points get a unique sentinel key range so they never block a
    # real voxel; old points (lower index) win their voxel by the stable sort.
    sentinel = (2_000_000_000
                - torch.arange(N, dtype=torch.int32, device=pts.device))
    keys = torch.where(ok > 0, keys, sentinel)
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                       sorted_keys[1:] != sorted_keys[:-1]])
    keep_sorted = first & (ok[order] > 0)

    # Score: valid and deduplicated, nearest to the sensor first.
    d = torch.linalg.vector_norm(pts[order] - center[None, :], dim=-1)
    in_range = d < cfg.keep_radius
    score = torch.where(keep_sorted & in_range, -d, -torch.inf)
    top, sel = _top(score, C)
    idx = order[sel]
    new_mask_out = (top > -torch.inf).to(dtype)
    return VoxelMap(points=pts[idx] * new_mask_out[:, None],
                    mask=new_mask_out)


def insert_hashed(
    m: VoxelMap,
    new_pts: torch.Tensor,
    new_mask: torch.Tensor,
    center: torch.Tensor,
    cfg: VoxelMapConfig,
) -> VoxelMap:
    """O(N) hash-table insert: slot = spatial-hash(voxel) mod capacity.

    1. evict slots beyond ``keep_radius`` of the sensor,
    2. scatter-min new points into *unoccupied* slots: the new point nearest
       the sensor wins its slot, old points stay authoritative.

    A point whose voxel hashes onto a slot held by another voxel is dropped
    for this sweep."""
    dtype = m.points.dtype
    C = cfg.capacity

    d_old = torch.linalg.vector_norm(m.points - center[None, :], dim=-1)
    alive = m.mask * (d_old < cfg.keep_radius).to(dtype)

    # The hash multiplies in int32 and wraps around, like XLA's int32
    # arithmetic; torch.abs(INT32_MIN) stays negative there too, and
    # torch.remainder (not fmod) gives the floor-modulo of jnp's %, so the
    # slot is always in [0, C).
    g = torch.floor(new_pts / cfg.leaf).to(torch.int32)
    h = ((g[:, 0] * 73856093) ^ (g[:, 1] * 19349663)
         ^ (g[:, 2] * 83492791))
    slot = torch.remainder(torch.abs(h), C).to(torch.int64)

    d_new = torch.linalg.vector_norm(new_pts - center[None, :], dim=-1)
    ok_new = (new_mask > 0) & (d_new < cfg.keep_radius)
    prio = torch.where(ok_new, d_new, torch.inf)
    best = torch.full((C,), torch.inf, dtype=dtype, device=m.points.device)
    best = best.scatter_reduce(0, slot, prio, reduce="amin")
    win = ok_new & (prio <= best[slot]) & (alive[slot] <= 0)
    # Several winners can share a slot at equal priority — routinely: the
    # ground points of one ring are all equidistant from the sensor. XLA's
    # scatter applies the updates in order, so on the CPU the highest point
    # index lands last and stays; a CUDA index_put_ would pick any. Here
    # the highest index wins explicitly, deterministically.
    tgt = torch.where(win, slot, C)                 # losers go to slot C
    order = torch.arange(new_pts.shape[0], device=new_pts.device)
    win = win & (_scatter.last_writer(C + 1, tgt)[slot] == order)
    tgt = torch.where(win, slot, C)
    points = torch.cat([m.points, m.points[:1]], dim=0)
    points[tgt] = new_pts.to(dtype)
    mask = torch.cat([alive, alive[:1]], dim=0)
    mask.index_fill_(0, tgt, 1.0)
    points, mask = points[:C], mask[:C]
    return VoxelMap(points=points * mask[:, None], mask=mask)


def insert_auto(m, new_pts, new_mask, center, cfg: VoxelMapConfig):
    """Dispatch on cfg.hashed."""
    if cfg.hashed:
        return insert_hashed(m, new_pts, new_mask, center, cfg)
    return insert(m, new_pts, new_mask, center, cfg)


def submap(
    m: VoxelMap,
    center: torch.Tensor,
    budget: int,
    radius: float = 100.0,
    approx: bool = False,
) -> VoxelMap:
    """Nearest-``budget`` points within ``radius`` of the sensor — the
    registration target set.

    Selection is exact for both values of ``approx`` (the TPU's approximate
    top-k has no counterpart here; on the CPU JAX's is exact too). A stable
    descending sort resolves ties to the lowest index, as ``lax.top_k``."""
    d = torch.linalg.vector_norm(m.points - center[None, :], dim=-1)
    score = torch.where((m.mask > 0) & (d < radius), -d, -torch.inf)
    top, idx = _top(score, budget)
    ok = (top > -torch.inf).to(m.points.dtype)
    return VoxelMap(points=m.points[idx] * ok[:, None], mask=ok)

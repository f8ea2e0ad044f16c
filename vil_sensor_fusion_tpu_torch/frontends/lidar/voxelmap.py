"""Fixed-capacity voxel feature map (open-addressed spatial hash).

Port of ``vil_sensor_fusion_tpu/frontends/lidar/voxelmap.py``: the hashed
insert and the nearest-``budget`` submap. The exact argsort ``insert`` is
not ported yet; ``insert_auto`` raises for ``hashed=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import DEFAULT_DEVICE


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
    order = torch.arange(new_pts.shape[0], device=new_pts.device)
    last = torch.full((C + 1,), -1, dtype=torch.int64, device=new_pts.device)
    tgt = torch.where(win, slot, C)                 # losers go to slot C
    last = last.scatter_reduce(0, tgt, order, reduce="amax")
    win = win & (last[slot] == order)
    tgt = torch.where(win, slot, C)
    points = torch.cat([m.points, m.points[:1]], dim=0)
    points[tgt] = new_pts.to(dtype)
    mask = torch.cat([alive, alive[:1]], dim=0)
    mask[tgt] = 1.0
    points, mask = points[:C], mask[:C]
    return VoxelMap(points=points * mask[:, None], mask=mask)


def insert_auto(m, new_pts, new_mask, center, cfg: VoxelMapConfig):
    """Dispatch on cfg.hashed (only the hashed insert is ported)."""
    if not cfg.hashed:
        raise NotImplementedError("the exact argsort voxel insert is not "
                                  "ported; use VoxelMapConfig(hashed=True)")
    return insert_hashed(m, new_pts, new_mask, center, cfg)


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
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:budget], idx[:budget]
    ok = (top > -torch.inf).to(m.points.dtype)
    return VoxelMap(points=m.points[idx] * ok[:, None], mask=ok)

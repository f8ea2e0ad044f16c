"""Analytic LiDAR simulation: raycast worlds of planes and boxes.

Port of ``vil_sensor_fusion_tpu/data/raycast.py``: ``World``; the worlds
(``corridor_world`` and ``arena_world``, the degenerate cases; ``town_world``
and ``road_world``, well conditioned; ``field_world`` and ``tunnel_world``,
which enter and leave degeneracy mid-drive); ``cast``; the LiDAR sweeps
(``raycast``, ``sweep_series`` and the motion-distorted ``raycast_motion``)
and the camera renderer (``render_camera``, ``render_camera_series``).

The random worlds are drawn from a ``numpy.random.Generator``: JAX's PRNG
stream cannot be reproduced here, so a port world equals a JAX world only
when its arrays are handed over (``convert.to_torch``), not when built from
the same seed. The corridor and the arena are drawn from no RNG.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..core import lie
from ..frontends.lidar.rangeimage import (
    AZIMUTH, RINGS, Sweep, VLP16_ELEVATIONS_DEG)


class World(NamedTuple):
    """Planes: n·x + d = 0 with n unit; boxes: AABBs."""

    plane_n: torch.Tensor     # (P, 3)
    plane_d: torch.Tensor     # (P,)
    box_min: torch.Tensor     # (B, 3)
    box_max: torch.Tensor     # (B, 3)


def _world(plane_n, plane_d, box_min, box_max, dtype, device) -> World:
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)
    return World(plane_n=t(plane_n), plane_d=t(plane_d), box_min=t(box_min),
                 box_max=t(box_max))


def _boxes(centers, sizes, heights):
    """AABBs standing on the ground from (n, 2) centres and sizes and (n,)
    heights."""
    n = len(heights)
    bmin = np.concatenate([centers - sizes / 2, np.zeros((n, 1))], -1)
    bmax = np.concatenate([centers + sizes / 2, heights[:, None]], -1)
    return bmin, bmax


def _sink(bmin, bmax, bad):
    """Move the boxes ``bad`` far below the ground instead of dropping
    them, so every world of a kind keeps its shapes."""
    bmin, bmax = bmin.copy(), bmax.copy()
    bmin[bad, 2] = -100.0
    bmax[bad, 2] = -99.0
    return bmin, bmax


_GROUND = ([[0.0, 0.0, 1.0]], [0.0])
_NO_BOXES = (np.zeros((0, 3)), np.zeros((0, 3)))


def corridor_world(width: float = 8.0, height: float = 5.0,
                   dtype=torch.float32, device=DEFAULT_DEVICE) -> World:
    """Ground plane + two walls along the x axis + ceiling (a tunnel)."""
    n = [[0.0, 0.0, 1.0],      # ground z = 0 (sensor above)
         [0.0, 1.0, 0.0],      # wall y = -width/2
         [0.0, -1.0, 0.0],     # wall y = +width/2
         [0.0, 0.0, -1.0]]     # ceiling z = height
    d = [0.0, width / 2.0, width / 2.0, height]
    return _world(n, d, *_NO_BOXES, dtype, device)


def town_world(n_boxes: int = 24, seed: int = 0, extent: float = 60.0,
               dtype=torch.float32, device=DEFAULT_DEVICE) -> World:
    """Ground plane + random 'buildings' scattered around the origin,
    cleared of a central street (|y| ≥ 8 m) so trajectories don't collide."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_boxes, 2))
    cy = centers[:, 1]
    cy = np.where(np.abs(cy) < 8.0, np.sign(cy + 1e-3) * 8.0 + cy, cy)
    centers = np.stack([centers[:, 0], cy], axis=-1)
    sizes = rng.uniform(2.0, 8.0, (n_boxes, 2))
    heights = rng.uniform(3.0, 12.0, (n_boxes,))
    return _world(*_GROUND, *_boxes(centers, sizes, heights), dtype, device)


def _road_boxes(length: float, n_boxes: int | None, seed: int,
                lane_half_width: float, max_offset: float):
    if n_boxes is None:
        n_boxes = max(32, int(length / 2.5))
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-20.0, length + 20.0, n_boxes)
    side = np.where(rng.random(n_boxes) < 0.5, 1.0, -1.0)
    cy = side * rng.uniform(lane_half_width, max_offset, n_boxes)
    sizes = rng.uniform(2.0, 8.0, (n_boxes, 2))
    heights = rng.uniform(3.0, 12.0, n_boxes)
    return _boxes(np.stack([cx, cy], axis=-1), sizes, heights)


def road_world(length: float = 240.0, n_boxes: int | None = None,
               seed: int = 0, lane_half_width: float = 8.0,
               max_offset: float = 45.0, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> World:
    """Ground plane + 'buildings' lining a road along +x from 0 to
    ``length`` (the long-drive world): box density per road-metre is
    constant, so the sensors see town-like geometry for the whole drive."""
    return _world(*_GROUND, *_road_boxes(length, n_boxes, seed,
                                        lane_half_width, max_offset),
                  dtype, device)


def field_world(x0: float, x1: float, length: float, seed: int = 0,
                dtype=torch.float32, device=DEFAULT_DEVICE) -> World:
    """Road-lined drive with an OPEN FIELD over x ∈ [x0, x1]: bare ground
    inside, so yaw and x/y translation starve there (the reference's
    plane/open-road bags, labeled rot AND trans degenerate)."""
    bmin, bmax = _road_boxes(length, None, seed, 8.0, 45.0)
    bad = (bmax[:, 0] > x0) & (bmin[:, 0] < x1)
    return _world(*_GROUND, *_sink(bmin, bmax, bad), dtype, device)


def arena_world(radius: float = 9.0, faces: int = 96, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> World:
    """Ground plane + a near-circular wall (a ``faces``-gon prism) around
    the origin: for a sensor at the centre, yaw moves every wall point
    along its own surface, so the Hessian's yaw direction collapses while
    the translations stay constrained (the rotation-degenerate case)."""
    th = torch.arange(faces, dtype=dtype, device=device) / faces * 2 * torch.pi
    n_wall = torch.stack([-torch.cos(th), -torch.sin(th),
                          torch.zeros_like(th)], dim=-1)
    ground = torch.tensor([[0.0, 0.0, 1.0]], dtype=dtype, device=device)
    d = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                   torch.full((faces,), radius, dtype=dtype, device=device)])
    zero = torch.zeros((0, 3), dtype=dtype, device=device)
    return World(plane_n=torch.cat([ground, n_wall]), plane_d=d,
                 box_min=zero, box_max=zero)


def tunnel_world(x0: float = 20.0, x1: float = 44.0, width: float = 8.0,
                 height: float = 5.0, n_boxes: int = 24, seed: int = 0,
                 extent: float = 60.0, road_length: float | None = None,
                 dtype=torch.float32, device=DEFAULT_DEVICE) -> World:
    """Town (or, with ``road_length``, a road of that length) with a tunnel
    over x ∈ [x0, x1]: buildings outside, two long walls (thin boxes) and a
    ceiling slab inside. Reference-length drives need the road base: the
    town scatters its buildings about the origin only."""
    if road_length is not None:
        bmin, bmax = _road_boxes(road_length, None, seed, 8.0, 45.0)
    else:
        base = town_world(n_boxes=n_boxes, seed=seed, extent=extent,
                          dtype=torch.float64, device="cpu")
        bmin, bmax = base.box_min.numpy(), base.box_max.numpy()
    bad = (bmax[:, 0] > x0 - 4.0) & (bmin[:, 0] < x1 + 4.0)
    bmin, bmax = _sink(bmin, bmax, bad)
    t = 0.5  # wall thickness
    walls = np.array([
        [[x0, -width / 2 - t, 0.0], [x1, -width / 2, height]],      # left
        [[x0, width / 2, 0.0], [x1, width / 2 + t, height]],        # right
        [[x0, -width / 2 - t, height], [x1, width / 2 + t, height + t]],
    ])
    return _world(*_GROUND, np.concatenate([bmin, walls[:, 0]]),
                  np.concatenate([bmax, walls[:, 1]]), dtype, device)


def cast(
    world: World,
    origin: torch.Tensor,        # (3,) or (..., 3) world-frame ray origins
    dirs: torch.Tensor,          # (..., 3) world-frame unit directions
    min_range: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit distance t (inf = miss) and the surface normal at the
    hit (oriented against the ray). ``origin`` is one point or one per ray
    (any shape that broadcasts against ``dirs``)."""
    dtype, device = dirs.dtype, dirs.device
    o = origin
    batch = dirs.shape[:-1]

    if world.plane_n.shape[0]:
        num = -(o @ world.plane_n.T + world.plane_d)               # (..., P)
        den = torch.einsum("pk,...k->...p", world.plane_n, dirs)   # (..., P)
        t_pl = num / torch.where(torch.abs(den) < 1e-9, 1e-9, den)
        t_pl = torch.where((t_pl > min_range) & (den != 0), t_pl, torch.inf)
        i_pl = torch.argmin(t_pl, dim=-1)
        t_plane = torch.gather(t_pl, -1, i_pl[..., None])[..., 0]
        n_plane = world.plane_n[i_pl]                              # (..., 3)
        s = -torch.sign(torch.einsum("...k,...k->...", n_plane, dirs))
        n_plane = n_plane * s[..., None]
    else:
        t_plane = torch.full(batch, torch.inf, dtype=dtype, device=device)
        n_plane = torch.zeros(batch + (3,), dtype=dtype, device=device)

    if world.box_min.shape[0]:
        safe = torch.where(torch.abs(dirs) < 1e-9, 1e-9, dirs)
        o_b = o[..., None, :]
        t1 = (world.box_min - o_b) / safe[..., None, :]            # (..., B, 3)
        t2 = (world.box_max - o_b) / safe[..., None, :]
        tlo = torch.minimum(t1, t2)
        thi = torch.maximum(t1, t2)
        tmin = torch.amax(tlo, dim=-1)                             # (..., B)
        tmax = torch.amin(thi, dim=-1)
        hit = (tmax >= tmin) & (tmin > min_range)
        t_bx = torch.where(hit, tmin, torch.inf)
        i_bx = torch.argmin(t_bx, dim=-1)
        t_box = torch.gather(t_bx, -1, i_bx[..., None])[..., 0]
        tlo_w = torch.gather(
            tlo, -2, i_bx[..., None, None].expand(batch + (1, 3)))[..., 0, :]
        axis = torch.argmax(tlo_w, dim=-1)
        n_box = torch.nn.functional.one_hot(axis, 3).to(dtype)
        n_box = n_box * -torch.sign(torch.gather(dirs, -1, axis[..., None]))
    else:
        t_box = torch.full(batch, torch.inf, dtype=dtype, device=device)
        n_box = torch.zeros(batch + (3,), dtype=dtype, device=device)

    use_box = t_box < t_plane
    t = torch.where(use_box, t_box, t_plane)
    n = torch.where(use_box[..., None], n_box, n_plane)
    return t, n


def _procedural_intensity(p_world: torch.Tensor, normal: torch.Tensor,
                          dtype) -> torch.Tensor:
    """World-anchored multi-scale texture + diffuse shading: dense,
    geometrically consistent image gradients for corner detection and KLT
    (the role Carla's textured meshes play for ROVIO)."""
    x, y, z = p_world[..., 0], p_world[..., 1], p_world[..., 2]
    tex = (torch.sin(2.1 * x + 0.7) * torch.sin(1.7 * y + 1.3)
           + 0.6 * torch.sin(5.3 * x + 2.9 * z + 0.5)
           * torch.sin(4.1 * y - 1.9 * z)
           + 0.35 * torch.sin(11.7 * y + 7.1 * z + 2.0)
           * torch.sin(9.3 * x - 6.7 * z))
    sun = torch.tensor([0.40824829, 0.40824829, -0.81649658], dtype=dtype,
                       device=p_world.device)
    light = torch.clamp(-torch.einsum("...k,k->...", normal, sun), 0.0, 1.0)
    return torch.clamp(0.45 + 0.25 * light + 0.13 * tex, 0.0, 1.0)


def render_camera(
    world: World,
    pose_wc: torch.Tensor,      # (7,) world_T_camera (x right, y down, z fwd)
    cam,                        # frontends.vio.camera.Camera
    max_range: float = 200.0,
    sky_level: float = 0.85,
) -> torch.Tensor:
    """Render a grayscale image (H, W) in [0, 255] from a camera pose:
    raycast every pixel against the world and shade it with the
    world-anchored procedural texture (the stand-in for the reference's
    800×600 Carla RGB camera)."""
    dtype, device = pose_wc.dtype, pose_wc.device
    H, W = cam.height, cam.width
    u = (torch.arange(W, dtype=dtype, device=device) + 0.5 - cam.cx) / cam.fx
    v = (torch.arange(H, dtype=dtype, device=device) + 0.5 - cam.cy) / cam.fy
    dirs_c = torch.stack([
        u[None, :].expand(H, W),
        v[:, None].expand(H, W),
        torch.ones((H, W), dtype=dtype, device=device),
    ], dim=-1)
    dirs_c = dirs_c / torch.linalg.vector_norm(dirs_c, dim=-1, keepdim=True)
    q = lie.pose_quat(pose_wc)
    o = lie.pose_trans(pose_wc)
    dirs_w = lie.quat_rotate(q[None, None, :], dirs_c)

    t, n = cast(world, o, dirs_w, min_range=0.05)
    hit = t < max_range
    t_safe = torch.where(hit, t, 0.0)
    p_hit = o + t_safe[..., None] * dirs_w
    shade = _procedural_intensity(p_hit, n, dtype)
    img = torch.where(hit, shade, sky_level)
    return img * 255.0


def render_camera_series(world: World, poses_wc: torch.Tensor, cam,
                         **kw) -> torch.Tensor:
    """(T, 7) camera poses → (T, H, W) frames, one frame at a time: a
    batched render would hold (T, H, W, boxes, 3) ray-slab intermediates."""
    return torch.stack([render_camera(world, p, cam, **kw)
                        for p in poses_wc])


def _ray_dirs(dtype, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(R, A, 3) unit ray directions in the sensor frame (VLP-16 grid)."""
    elev = torch.deg2rad(torch.as_tensor(VLP16_ELEVATIONS_DEG, dtype=dtype,
                                         device=device))
    az = ((torch.arange(AZIMUTH, dtype=dtype, device=device) + 0.5)
          / AZIMUTH * 2 * torch.pi - torch.pi)
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(az)[None, :], torch.sin(az)[None, :]
    return torch.stack([ce * ca, ce * sa, se * torch.ones_like(ca)], dim=-1)


def raycast(world: World, pose: torch.Tensor, max_range: float = 120.0,
            min_range: float = 0.5) -> Sweep:
    """Cast the full VLP-16 grid from ``pose`` (world_T_sensor); returns an
    organized :class:`Sweep` in the sensor frame."""
    dtype = pose.dtype
    dirs_s = _ray_dirs(dtype, pose.device)
    q = lie.pose_quat(pose)
    o = lie.pose_trans(pose)
    dirs = lie.quat_rotate(q[None, None, :], dirs_s)

    t, _ = cast(world, o, dirs, min_range=min_range)
    valid = (t < max_range).to(dtype)
    t_safe = torch.where(valid > 0, t, 0.0)
    pts_w = o + t_safe[..., None] * dirs
    pts_s = lie.quat_rotate(lie.quat_conjugate(q)[None, None, :], pts_w - o)
    return Sweep(xyz=pts_s * valid[..., None], rng=t_safe, mask=valid)


def sweep_series(world: World, poses: torch.Tensor,
                 max_range: float = 120.0) -> Sweep:
    """(T, 7) poses → stacked Sweeps (T, R, A, ·), one raycast at a time."""
    sweeps = [raycast(world, p, max_range) for p in poses]
    return Sweep(*(torch.stack(f, dim=0) for f in zip(*sweeps)))


def raycast_motion(world: World, pose_start: torch.Tensor,
                   pose_end: torch.Tensor, max_range: float = 120.0,
                   min_range: float = 0.5) -> Sweep:
    """Motion-DISTORTED sweep: azimuth column ``a`` is cast from the sensor
    pose at scan fraction (a+0.5)/A (constant-velocity screw interpolation
    start→end) and its points are kept in that column's own sensor frame,
    uncompensated, as a spinning LiDAR records them while moving. One
    ``cast`` over the whole (R, A) grid with one origin per column."""
    dtype, device = pose_start.dtype, pose_start.device
    dirs_s = _ray_dirs(dtype, device)                            # (R, A, 3)
    A = dirs_s.shape[1]
    frac = (torch.arange(A, dtype=dtype, device=device) + 0.5) / A
    xi = lie.se3_log(lie.pose_between(pose_start, pose_end))     # (6,)
    poses_t = lie.pose_compose(pose_start, lie.se3_exp(xi * frac[:, None]))
    q_t = lie.pose_quat(poses_t)                                 # (A, 4)
    o_t = lie.pose_trans(poses_t)                                # (A, 3)
    dirs = lie.quat_rotate(q_t[None], dirs_s)                    # world frame
    t, _ = cast(world, o_t, dirs, min_range=min_range)
    valid = (t < max_range).to(dtype)
    t_safe = torch.where(valid > 0, t, 0.0)
    pts_w = o_t[None] + t_safe[..., None] * dirs
    pts_s = lie.quat_rotate(lie.quat_conjugate(q_t)[None], pts_w - o_t[None])
    return Sweep(xyz=pts_s * valid[..., None], rng=t_safe, mask=valid)

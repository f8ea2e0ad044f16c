"""Image-driven VIO frontend: tracker slot management + LiDAR feature depth.

Port of ``vil_sensor_fusion_tpu/frontends/vio/frontend.py`` (useDepthFromLiDAR,
rovio.cfg:132-138: depth for a feature comes from the LiDAR sweep projected
into the camera):

  image ─→ pyramid ─→ KLT (continue slots) ──┐
  image ─→ Shi-Tomasi detect ─→ replenish ───┼─→ VioFrameInput per frame
  sweep points (camera frame) ─→ projected depths ┘

:func:`build_frames` runs it in two phases, as the JAX one does: the
batched phase (pyramids, detection, projected sweeps, candidate depths for
all frames at once) and the sequential phase (KLT from frame t−1 and slot
replenishment, a loop over frames). Slot management is static-shape: M
landmark slots, C candidates, rank matching of candidates to free slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import DEFAULT_DEVICE
from ...core import lie
from ...utils import tracing as TR
from . import camera as C
from . import tracker as T
from .pipeline import VioFrameInput


class FrontendConfig(NamedTuple):
    cam: C.Camera = C.carla_camera()
    pyramid_levels: int = 3
    klt_radius: int = 4
    klt_iters: int = 8
    klt_max_error: float = 12.0
    n_candidates: int = 64         # detection candidates per frame
    min_score: float = 1.0         # Shi-Tomasi acceptance threshold
    min_dist: float = 16.0         # min pixel distance to a live track
    nms_radius: int = 8
    border: int = 12
    # A feature's depth is that of the projected LiDAR return closest in
    # the image, within this pixel radius.
    depth_radius_px: float = 12.0
    max_depth: float = 120.0


class TrackerState(NamedTuple):
    pyr: tuple                     # previous frame's pyramid (L tensors)
    uv: torch.Tensor               # (M, 2) current track positions
    valid: torch.Tensor            # (M,)


def init_tracker(cfg: FrontendConfig, num_slots: int, dtype=torch.float32,
                 device=DEFAULT_DEVICE) -> TrackerState:
    h, w = cfg.cam.height, cfg.cam.width
    pyr = []
    for _ in range(cfg.pyramid_levels):
        pyr.append(torch.zeros((h, w), dtype=dtype, device=device))
        h, w = h // 2, w // 2
    return TrackerState(
        pyr=tuple(pyr),
        uv=torch.zeros((num_slots, 2), dtype=dtype, device=device),
        valid=torch.zeros((num_slots,), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# LiDAR feature depth (the useDepthFromLiDAR path)
# ---------------------------------------------------------------------------

def project_sweep(
    cfg: FrontendConfig,
    points_cam: torch.Tensor,      # (..., P, 3) sweep points, camera frame
    point_valid: torch.Tensor,     # (..., P)
) -> torch.Tensor:
    """Project the sweep into the image once: (..., P, 3) rows of
    (u, v, z), z = 0 marking returns that miss the image or range gates."""
    uv, ok = C.project(cfg.cam, points_cam)
    z = points_cam[..., 2]
    ok = ok & (point_valid > 0) & (z > 0.1) & (z < cfg.max_depth)
    zed = torch.where(ok, z, 0.0)
    return torch.stack([uv[..., 0], uv[..., 1], zed], dim=-1)


def depth_at(cfg: FrontendConfig, proj: torch.Tensor,
             uv: torch.Tensor) -> torch.Tensor:
    """Depth at each query pixel: the projected return CLOSEST IN THE IMAGE
    within ``depth_radius_px``; among returns at the same image distance
    the smallest z. ``proj`` is :func:`project_sweep`'s (..., P, 3), ``uv``
    (..., N, 2). Returns (..., N) depths, 0 where no return is near."""
    pu, pv, pz = (proj[..., None, :, i] for i in range(3))    # (..., 1, P)
    d2 = (pu - uv[..., 0, None]) ** 2 + (pv - uv[..., 1, None]) ** 2
    big = 1e12
    d2 = torch.where(pz > 0, d2, big)
    best = torch.amin(d2, dim=-1)
    sel = d2 <= best[..., None]
    z = torch.amin(torch.where(sel, pz, big), dim=-1)
    return torch.where(best <= cfg.depth_radius_px ** 2, z, 0.0)


def assign_candidates(
    cfg: FrontendConfig,
    live_uv: torch.Tensor,         # (M, 2) live feature positions
    live_valid: torch.Tensor,      # (M,)
    cand_uv: torch.Tensor,         # (C, 2) detection candidates
    cand_score: torch.Tensor,      # (C,)
    cand_depth: torch.Tensor,      # (C,) LiDAR depth per candidate (0 = none)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Filter candidates against live features and rank-match survivors to
    free slots. Returns (new_uv (M, 2), new_depth (M,), new_enable (M,))."""
    dtype = live_uv.dtype
    Cn = cand_uv.shape[0]

    # Drop candidates near live features or without depth.
    d2 = torch.sum((cand_uv[:, None, :] - live_uv[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(live_valid[None, :] > 0, d2, torch.inf)
    far = torch.amin(d2, dim=-1) > cfg.min_dist ** 2
    cand_ok = far & (cand_score > cfg.min_score) & (cand_depth > 0)

    # Suppress a candidate within min_dist of a better accepted one.
    cd2 = torch.sum((cand_uv[:, None, :] - cand_uv[None, :, :]) ** 2, dim=-1)
    ar = torch.arange(Cn, device=cand_uv.device)
    earlier = ar[None, :] < ar[:, None]
    clash = torch.any((cd2 < cfg.min_dist ** 2) & earlier & cand_ok[None, :],
                      dim=-1)
    cand_ok = cand_ok & ~clash

    # The r-th accepted candidate fills the r-th free slot.
    free = live_valid <= 0
    slot_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    order = torch.argsort((~cand_ok).to(torch.int32), stable=True)
    n_ok = torch.sum(cand_ok.to(torch.int32))
    cand_for_slot = order[torch.clamp(slot_rank, 0, Cn - 1).long()]
    assign = free & (slot_rank < n_ok)

    new_uv = torch.where(assign[:, None], cand_uv[cand_for_slot], 0.0)
    new_depth = torch.where(assign, cand_depth[cand_for_slot], 1.0)
    return new_uv, new_depth, assign.to(dtype)


# ---------------------------------------------------------------------------
# Per-frame step
# ---------------------------------------------------------------------------

def _track_and_assign(
    cfg: FrontendConfig,
    ts: TrackerState,
    pyr_new: tuple,                # this frame's pyramid
    cand_uv: torch.Tensor,         # (C, 2) detection candidates
    cand_score: torch.Tensor,      # (C,)
    cand_depth: torch.Tensor,      # (C,)
    proj: torch.Tensor,            # (P, 3) this frame's projected sweep
) -> tuple[TrackerState, tuple]:
    """Continue tracks via KLT, query each continued track's LiDAR depth,
    and fill freed slots from the candidate set."""
    obs_uv, obs_valid = T.klt_track(
        list(ts.pyr), list(pyr_new), ts.uv, ts.valid,
        radius=cfg.klt_radius, iters=cfg.klt_iters,
        max_error=cfg.klt_max_error)
    obs_valid = obs_valid * ts.valid   # dead slots stay dead through KLT
    obs_depth = depth_at(cfg, proj, obs_uv) * obs_valid

    new_uv, new_depth, new_enable = assign_candidates(
        cfg, obs_uv, obs_valid, cand_uv, cand_score, cand_depth)

    uv_next = torch.where(new_enable[:, None] > 0, new_uv, obs_uv)
    valid_next = torch.maximum(obs_valid, new_enable)
    return (
        TrackerState(pyr=tuple(pyr_new), uv=uv_next, valid=valid_next),
        (obs_uv, obs_valid, obs_depth, new_uv, new_depth, new_enable),
    )


def frontend_step(
    cfg: FrontendConfig,
    ts: TrackerState,
    image: torch.Tensor,           # (H, W) grayscale
    points_cam: torch.Tensor,      # (P, 3) latest sweep in this camera frame
    point_valid: torch.Tensor,     # (P,)
) -> tuple[TrackerState, tuple]:
    """Track + replenish one frame. Returns the per-frame observation
    block (obs_uv, obs_valid, obs_depth, new_uv, new_depth, new_enable)."""
    pyr_new = tuple(T.pyramid(image, cfg.pyramid_levels))
    proj = project_sweep(cfg, points_cam, point_valid)
    cand_uv, cand_score = T.detect(
        image, cfg.n_candidates, nms_radius=cfg.nms_radius,
        border=cfg.border)
    cand_depth = depth_at(cfg, proj, cand_uv)
    return _track_and_assign(cfg, ts, pyr_new, cand_uv, cand_score,
                             cand_depth, proj)


def pyramids_batch(cfg: FrontendConfig, images: torch.Tensor) -> tuple:
    """Pyramids of all frames: tuple of (T, h_l, w_l); of all lanes' frames
    for (B, T, H, W) images, tuple of (B, T, h_l, w_l)."""
    with TR.span("frontend.pyramids"):
        return tuple(T.pyramid(images, cfg.pyramid_levels))


def candidates_batch(
    cfg: FrontendConfig,
    images: torch.Tensor,          # (T, H, W)
    points_cam: torch.Tensor,      # (T, P, 3)
    point_valid: torch.Tensor,     # (T, P)
):
    """Shi-Tomasi detection + projected sweeps + candidate depths for all
    frames: (cand_uv (T,C,2), cand_score (T,C), cand_depth (T,C),
    projs (T,P,3)). Every op maps over leading axes, so (B, T, ·) inputs
    give the same for all lanes' frames at once."""
    with TR.span("frontend.candidates"):
        cand_uv, cand_score = T.detect(images, cfg.n_candidates,
                                       nms_radius=cfg.nms_radius,
                                       border=cfg.border)
        projs = project_sweep(cfg, points_cam, point_valid)
        cand_depth = depth_at(cfg, projs, cand_uv)
    return cand_uv, cand_score, cand_depth, projs


def precompute_frames(cfg: FrontendConfig, images: torch.Tensor,
                      points_cam: torch.Tensor, point_valid: torch.Tensor):
    """Phase 1 of the frontend, everything with no sequential dependency:
    (pyramids, cand_uv, cand_score, cand_depth, projs)."""
    pyrs = pyramids_batch(cfg, images)
    return (pyrs,) + candidates_batch(cfg, images, points_cam, point_valid)


def track_frames(
    cfg: FrontendConfig,
    pyrs: tuple,
    cand_uv: torch.Tensor,
    cand_score: torch.Tensor,
    cand_depth: torch.Tensor,
    projs: torch.Tensor,
    imu_windows: tuple,
    num_slots: int,
    ts0: TrackerState | None = None,
) -> tuple[VioFrameInput, TrackerState]:
    """Phase 2 of the frontend, the sequential part: KLT from frame t−1
    plus slot replenishment, a loop over frames carrying the previous
    frame's pyramid. ``ts0`` continues a previous chunk's tracker; returns
    the final state for the next chunk."""
    dtype = pyrs[0].dtype
    if ts0 is None:
        ts0 = init_tracker(cfg, num_slots, dtype, pyrs[0].device)
    ts, outs = ts0, []
    with TR.span("frontend.track"):
        TR.count("frontend.frames", cand_uv.shape[0])
        for t in range(cand_uv.shape[0]):
            ts, out = _track_and_assign(
                cfg, ts, tuple(p[t] for p in pyrs), cand_uv[t],
                cand_score[t], cand_depth[t], projs[t])
            outs.append(out)
        obs_uv, obs_valid, obs_depth, new_uv, new_depth, new_enable = (
            torch.stack(f) for f in zip(*outs))
        accel, gyro, dts = (x.to(dtype) for x in imu_windows)
    return VioFrameInput(
        accel=accel, gyro=gyro, dts=dts,
        obs_uv=obs_uv, obs_valid=obs_valid, obs_depth=obs_depth,
        new_uv=new_uv, new_depth=new_depth, new_enable=new_enable,
    ), ts


def track_frames_lanes(
    cfg: FrontendConfig,
    pyrs: tuple,                   # L tensors (B, T, h_l, w_l)
    cand_uv: torch.Tensor,         # (B, T, C, 2)
    cand_score: torch.Tensor,      # (B, T, C)
    cand_depth: torch.Tensor,      # (B, T, C)
    projs: torch.Tensor,           # (B, T, P, 3)
    imu_windows: tuple,            # (B, T, N, ·) each
    num_slots: int,
) -> VioFrameInput:
    """B image streams through the tracker at once, one set of ops per
    frame for all lanes: what ``jax.vmap(lambda ...: track_frames(...)[0])``
    computes (the bench's tracking stage). Frames (B, T, ·)."""
    def one(py, cu, cs, cd, pj, iw):
        return track_frames(cfg, py, cu, cs, cd, pj, iw, num_slots)[0]
    return torch.func.vmap(one)(tuple(pyrs), cand_uv, cand_score,
                                cand_depth, projs, tuple(imu_windows))


def build_frames(
    cfg: FrontendConfig,
    images: torch.Tensor,          # (T, H, W) grayscale
    points_cam: torch.Tensor,      # (T, P, 3) sweep points per frame (cam frame)
    point_valid: torch.Tensor,     # (T, P)
    imu_windows: tuple,            # (accel (T,N,3), gyro (T,N,3), dts (T,N))
    num_slots: int,
) -> VioFrameInput:
    """Run the tracker over an image sequence → the VioFrameInput stream
    the EKF consumes (the image-driven replacement for
    synthetic.make_frames)."""
    pyrs, cand_uv, cand_score, cand_depth, projs = precompute_frames(
        cfg, images, points_cam, point_valid)
    frames, _ = track_frames(cfg, pyrs, cand_uv, cand_score, cand_depth,
                             projs, imu_windows, num_slots)
    return frames


def forward_camera_extrinsics(dtype=torch.float32,
                              device=DEFAULT_DEVICE) -> torch.Tensor:
    """imu_T_camera for a forward-looking camera on an x-forward/z-up IMU:
    camera z → IMU x, camera x → IMU −y, camera y → IMU −z."""
    R_ic = torch.tensor([[0.0, 0.0, 1.0],
                         [-1.0, 0.0, 0.0],
                         [0.0, -1.0, 0.0]], dtype=dtype, device=device)
    return torch.cat([lie.rot_to_quat(R_ic),
                      torch.zeros(3, dtype=dtype, device=device)])


def sweep_to_camera(
    sweep_xyz: torch.Tensor,       # (..., 3) points in the LiDAR sensor frame
    sweep_mask: torch.Tensor,      # (...)
    pose_cl: torch.Tensor,         # (7,) camera_T_lidar extrinsics
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten a sweep and move it into the camera frame."""
    pts = sweep_xyz.reshape(-1, 3)
    mask = sweep_mask.reshape(-1)
    pts_c = (lie.quat_rotate(lie.pose_quat(pose_cl)[None], pts)
             + lie.pose_trans(pose_cl)[None])
    return pts_c, mask

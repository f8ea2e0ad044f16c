"""LiDAR odometry pipeline: motion undistortion → feature extraction →
two-stage registration (scan-to-scan odometry, then scan-to-map refinement)
→ map update.

Per sweep it returns the odometry pose, the 6×6 ICP Hessian (the
degeneracy signal), a pose covariance and, with ``emit_dists``, the
perturbation-sweep correspondence distances behind the dist_slope metrics.

Port of ``vil_sensor_fusion_tpu/frontends/lidar/odometry.py``. ``run`` is a
Python loop over sweeps in place of ``lax.scan``. Its per-sweep control is
device-side (``torch.where`` on the ``initialized`` flag), so a run makes
no host round trip; the first sweep registers against the empty map like
the JAX scan does and keeps the guess. The per-sweep covariance runs once,
batched over all sweeps, after the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import DEFAULT_DEVICE, _tree
from ...core import lie
from ...ops import eig6 as E6
from . import features as feat
from . import icp as I
from . import rangeimage as RI
from . import voxelmap as vm
from .rangeimage import Sweep


class LidarOdomConfig(NamedTuple):
    icp: I.IcpConfig = I.IcpConfig()
    odom_icp: I.IcpConfig = I.IcpConfig(iters=8, max_corr_dist=2.0,
                                        degen_eigval=5.0)
    two_stage: bool = True       # scan-to-scan odometry before mapping
    undistort: bool = True       # ego-motion compensation (scanPeriod)
    emit_dists: bool = False     # perturbation-sweep correspondence dists
    dists_shifts: int = 15       # S of the 6×S dists arrays
    corner_map: vm.VoxelMapConfig = vm.VoxelMapConfig(capacity=32768,
                                                      leaf=0.2)
    surf_map: vm.VoxelMapConfig = vm.VoxelMapConfig(capacity=65536,
                                                    leaf=0.4)
    submap_corners: int = 4096
    submap_surfs: int = 8192
    submap_radius: float = 100.0
    # Kept for config parity; the port's submap selection is always exact.
    submap_approx: bool = True
    min_dof: float = 12.0
    # ``pose_guess`` is the RELATIVE motion since the previous sweep.
    guess_is_delta: bool = False
    rings: int = RI.RINGS
    azimuth: int = RI.AZIMUTH


class LidarOdomState(NamedTuple):
    corner_map: vm.VoxelMap
    surf_map: vm.VoxelMap
    pose: torch.Tensor        # (7,) world_T_sensor of the last sweep
    initialized: torch.Tensor  # scalar 0/1
    prev_corners: torch.Tensor      # (Nc, 3) world frame
    prev_corner_mask: torch.Tensor  # (Nc,)
    prev_surfs: torch.Tensor        # (Ns, 3)
    prev_surf_mask: torch.Tensor    # (Ns,)


class LidarOdomResult(NamedTuple):
    pose: torch.Tensor        # (7,) mapping-stage (final) pose
    hessian: torch.Tensor     # (6, 6) — the degeneracy signal
    cov: torch.Tensor         # (6, 6)
    degenerate: torch.Tensor  # (6,)
    n_corr: torch.Tensor
    cost: torch.Tensor
    odom_pose: torch.Tensor     # (7,) scan-to-scan stage
    odom_hessian: torch.Tensor  # (6, 6)
    # Perturbation-sweep correspondence distances (zeros when disabled).
    dists: I.PerturbationDists


def _zero_dists(cfg: LidarOdomConfig, dtype, device) -> I.PerturbationDists:
    S = cfg.dists_shifts

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return I.PerturbationDists(dists=z(6, S), dists_corner=z(6, S),
                               dists_surface=z(6, S), shift_trans=z(S),
                               shift_rot=z(S))


def init(cfg: LidarOdomConfig, dtype=torch.float32,
         pose0: torch.Tensor | None = None, device=None) -> LidarOdomState:
    """``pose0``: initial world_T_sensor (required in guess_is_delta mode
    when the trajectory does not start at the origin). ``device`` defaults
    to ``pose0``'s, else the card."""
    if device is None:
        device = (pose0.device if isinstance(pose0, torch.Tensor)
                  else DEFAULT_DEVICE)
    nc, ns = feat.pool_sizes(cfg.rings, cfg.azimuth)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LidarOdomState(
        corner_map=vm.empty(cfg.corner_map, dtype, device),
        surf_map=vm.empty(cfg.surf_map, dtype, device),
        pose=(lie.pose_identity(dtype, device) if pose0 is None
              else torch.as_tensor(pose0, dtype=dtype, device=device)),
        initialized=z(),
        prev_corners=z(nc, 3), prev_corner_mask=z(nc),
        prev_surfs=z(ns, 3), prev_surf_mask=z(ns),
    )


def _to_world(pose, pts):
    return (lie.quat_rotate(lie.pose_quat(pose)[None, :], pts)
            + lie.pose_trans(pose)[None, :])


def _covariance(cfg: LidarOdomConfig, hessian, cost, n_corr, has_map):
    """cov = σ² H⁻¹ with σ² = cost / max(n_corr − 6, min_dof); a weak
    identity where no map existed yet. Batched over leading axes; H⁻¹ via
    the fixed-sweep Jacobi."""
    dtype = hessian.dtype
    dof = torch.clamp(n_corr - 6.0, min=cfg.min_dof)
    sigma2 = torch.where(has_map, cost / dof, 1.0)
    eye6 = torch.eye(6, dtype=dtype, device=hessian.device)
    w6, V6 = E6.jacobi_eigh(hessian + 1e-6 * eye6)
    w6 = torch.clamp(w6, min=1e-8)
    H_inv = torch.einsum("...ij,...j,...kj->...ik", V6, 1.0 / w6, V6)
    return torch.where(has_map[..., None, None],
                       sigma2[..., None, None] * H_inv, eye6 * 1e2)


def step(
    cfg: LidarOdomConfig,
    state: LidarOdomState,
    sweep: Sweep,
    pose_guess: torch.Tensor,
    register_fn=None,
    compute_cov: bool = True,
) -> tuple[LidarOdomState, LidarOdomResult]:
    """Process one sweep. ``pose_guess`` is the motion prior (absolute, or
    relative in guess_is_delta mode).

    ``register_fn``: optional scan-to-map registration with
    ``icp.register``'s positional signature (pose0, q_c, m_c, q_s, m_s,
    map_c, map_cm, map_s, map_sm) → IcpResult — the hook the model-parallel
    path uses (``parallel.ops.make_sharded_register``)."""
    dtype = state.pose.dtype
    has_map = state.initialized > 0
    delta_guess = pose_guess
    if cfg.guess_is_delta:
        pose_guess = lie.pose_compose(state.pose, pose_guess)

    # --- Stage 0: motion undistortion ---------------------------------------
    if cfg.undistort:
        if cfg.guess_is_delta:
            # log(delta⁻¹) = −log(delta): state-independent, so the FIRST
            # sweep is undistorted too (the hashed map keeps the first
            # observation of every voxel).
            xi = -lie.se3_log(delta_guess)
        else:
            xi = lie.se3_log(lie.pose_between(pose_guess, state.pose))
            xi = torch.where(has_map, xi, torch.zeros_like(xi))
        sweep = RI.undistort(sweep, xi)

    fs = feat.extract(sweep)

    q_corners, q_corner_mask = fs.less_sharp, fs.less_sharp_mask
    q_surfs = torch.cat([fs.flat, fs.less_flat], dim=0)
    q_surf_mask = torch.cat([fs.flat_mask, fs.less_flat_mask], dim=0)

    # --- Stage 1: scan-to-scan odometry (laser_odometry) --------------------
    pose_init = pose_guess
    odom_pose = pose_guess
    odom_hessian = torch.zeros((6, 6), dtype=dtype, device=pose_guess.device)
    if cfg.two_stage:
        res_o = I.register(
            pose_guess,
            fs.sharp, fs.sharp_mask, fs.flat, fs.flat_mask,
            state.prev_corners, state.prev_corner_mask,
            state.prev_surfs, state.prev_surf_mask,
            cfg.odom_icp,
        )
        odom_pose = torch.where(has_map, res_o.pose, pose_guess)
        odom_hessian = res_o.hessian
        pose_init = odom_pose

    # --- Stage 2: scan-to-map refinement (laser_mapping) --------------------
    center = lie.pose_trans(pose_init)
    sub_c = vm.submap(state.corner_map, center, cfg.submap_corners,
                      cfg.submap_radius, approx=cfg.submap_approx)
    sub_s = vm.submap(state.surf_map, center, cfg.submap_surfs,
                      cfg.submap_radius, approx=cfg.submap_approx)
    if register_fn is None:
        def register_fn(*a):
            return I.register(*a, cfg.icp)

    res = register_fn(
        pose_init,
        q_corners, q_corner_mask, q_surfs, q_surf_mask,
        sub_c.points, sub_c.mask, sub_s.points, sub_s.mask,
    )
    pose = torch.where(has_map, res.pose, pose_guess)
    if not cfg.two_stage:
        odom_pose = pose
        odom_hessian = res.hessian

    if compute_cov:
        cov = _covariance(cfg, res.hessian, res.cost, res.n_corr, has_map)
    else:
        cov = torch.zeros((6, 6), dtype=dtype, device=pose.device)

    # --- Perturbation-sweep correspondence distances ------------------------
    if cfg.emit_dists:
        dists = I.perturbation_dists(
            pose, q_corners, q_corner_mask, q_surfs, q_surf_mask,
            sub_c.points, sub_c.mask, sub_s.points, sub_s.mask,
            cfg.icp, n_shifts=cfg.dists_shifts)
    else:
        dists = _zero_dists(cfg, dtype, pose.device)

    # --- Map + prev-sweep pool update ---------------------------------------
    w_corners = _to_world(pose, q_corners)
    w_surfs = _to_world(pose, q_surfs)
    cm = vm.insert_auto(state.corner_map, w_corners, q_corner_mask,
                        lie.pose_trans(pose), cfg.corner_map)
    sm = vm.insert_auto(state.surf_map, w_surfs, q_surf_mask,
                        lie.pose_trans(pose), cfg.surf_map)

    new_state = LidarOdomState(
        corner_map=cm, surf_map=sm, pose=pose,
        initialized=torch.ones((), dtype=dtype, device=pose.device),
        prev_corners=w_corners, prev_corner_mask=q_corner_mask,
        prev_surfs=w_surfs, prev_surf_mask=q_surf_mask,
    )
    return new_state, LidarOdomResult(
        pose=pose, hessian=res.hessian, cov=cov,
        degenerate=res.degenerate, n_corr=res.n_corr, cost=res.cost,
        odom_pose=odom_pose, odom_hessian=odom_hessian, dists=dists,
    )


def run(
    cfg: LidarOdomConfig,
    state: LidarOdomState,
    sweeps: Sweep,                 # stacked (T, R, A, ·)
    pose_guesses: torch.Tensor,    # (T, 7) per-sweep priors
    register_fn=None,
) -> tuple[LidarOdomState, LidarOdomResult]:
    """Loop over a whole drive; results stacked along a leading T axis. The
    covariance (σ²H⁻¹) is computed once, batched over all T sweeps.
    ``register_fn`` as in :func:`step`."""
    init0 = state.initialized
    outs = []
    for t in range(pose_guesses.shape[0]):
        sweep = Sweep(*(x[t] for x in sweeps))
        state, res = step(cfg, state, sweep, pose_guesses[t],
                          register_fn=register_fn, compute_cov=False)
        outs.append(res)
    res = _tree.tree_map(lambda *xs: torch.stack(xs, dim=0), *outs)
    T = res.pose.shape[0]
    has_map = (torch.arange(T, device=init0.device) > 0) | (init0 > 0)
    cov = _covariance(cfg, res.hessian, res.cost, res.n_corr, has_map)
    return state, res._replace(cov=cov)


def run_lanes(
    cfg: LidarOdomConfig,
    state: LidarOdomState,         # every leaf with a leading lane axis B
    sweeps: Sweep,                 # (B, T, R, A, ·)
    pose_guesses: torch.Tensor,    # (B, T, 7)
) -> tuple[LidarOdomState, LidarOdomResult]:
    """B drives at once, one set of ops per sweep for all lanes: what
    ``jax.vmap(lambda st, sw, g: run(cfg, st, sw, g))`` computes (the
    bench's LiDAR stage). On the card each k-NN search of a sweep is one
    kernel launch for all lanes (``ops.knn``'s batching rule)."""
    return torch.func.vmap(lambda st, sw, g: run(cfg, st, sw, g))(
        state, sweeps, pose_guesses)

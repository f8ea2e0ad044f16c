"""Scan registration: batched KNN correspondence + point-to-line /
point-to-plane Gauss-Newton with an explicit 6×6 Hessian.

Port of ``vil_sensor_fusion_tpu/frontends/lidar/icp.py``: static shapes
with 0/1 masks, fixed GN iterations, LOAM's degeneracy-projected update, and
the same correspondence-refresh schedule (``fit_every`` /
``final_refresh``), and the per-DOF perturbation-sweep correspondence
distances (``perturbation_dists``) behind the dist_slope metrics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..._linspace import linspace0
from ...core import lie
from ...ops import eig3 as E3
from ...ops import eig6 as E6
from ...ops import knn as knn_ops

KNN_K = 5


class IcpConfig(NamedTuple):
    iters: int = 10                  # mapMaxIterations (25 for odometry mode)
    max_corr_dist: float = 1.0       # correspondence gating radius
    line_eig_ratio: float = 3.0      # λ1 > ratio·λ2 ⇒ valid line (LOAM rule)
    plane_fit_tol: float = 0.2       # max point-plane misfit in the 5-NN fit
    plane_eig_ratio: float = 3.0     # λ_mid > ratio·λ_min ⇒ genuinely planar
    plane_mid_eig_min: float = 0.01  # absolute 2nd-direction spread floor (m²)
    degen_eigval: float = 40.0       # mapDegenEigVal
    damping: float = 1e-6
    # Correspondence-refresh period: KNN + line/plane fits every
    # ``fit_every`` GN steps; fit_every=1 refreshes every step.
    fit_every: int = 1
    # Recompute correspondences at the solution for the reported stats
    # (True), or report the last inner step's H/cost (False).
    final_refresh: bool = True
    eig_sweeps: int = 6


class IcpResult(NamedTuple):
    pose: torch.Tensor        # (7,) refined target_T_sensor
    hessian: torch.Tensor     # (6, 6) GN Hessian at the solution (rho, theta)
    cost: torch.Tensor        # final weighted squared error
    n_corr: torch.Tensor      # number of valid correspondences (float)
    degenerate: torch.Tensor  # (6,) 1.0 per clamped eigen-direction


def knn(
    queries: torch.Tensor,     # (Q, 3)
    q_mask: torch.Tensor,      # (Q,)
    targets: torch.Tensor,     # (M, 3)
    t_mask: torch.Tensor,      # (M,)
    k: int = KNN_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked exact KNN: (idx (Q,k), dist² (Q,k)), ascending. Invalid
    queries return rows the caller masks through ``q_mask``.

    The distance rows ‖q‖² − 2q·t + ‖t‖² cancel at map coordinates, so they
    must be full f32: the CUDA kernel never uses tensor cores, and the plain
    version's matmul runs with TF32 off (``_precision.require_full_f32``)."""
    return knn_ops.knn(queries, targets, t_mask, k)


def _transform(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return (lie.quat_rotate(lie.pose_quat(pose)[None, :], pts)
            + lie.pose_trans(pose)[None, :])


def line_fits(pose, corners, corner_mask, map_corners, map_mask,
              cfg: IcpConfig):
    """5-NN line fits in the corner map at ``pose``: returns
    (centroid (Q,3), direction (Q,3), w (Q,))."""
    p_map = _transform(pose, corners)
    idx, d2 = knn(p_map.contiguous(), corner_mask, map_corners, map_mask)
    nn = map_corners[idx]                                 # (Q, K, 3)
    centroid = torch.mean(nn, dim=1)
    dc = nn - centroid[:, None, :]
    cov = torch.einsum("qki,qkj->qij", dc, dc) / KNN_K
    eigval, eigvec = E3.eigh3(cov)                        # ascending
    d = eigvec[..., -1]                                   # line direction
    is_line = eigval[..., -1] > cfg.line_eig_ratio * eigval[..., -2]
    near = d2[:, -1] < cfg.max_corr_dist ** 2             # worst NN in radius
    dtype = corners.dtype
    w = corner_mask * is_line.to(dtype) * near.to(dtype)
    return centroid, d, w


def _point_jacobian(pose, pts):
    """(Q, 3, 6) derivative of R·p + t w.r.t. the right (rho, theta)
    perturbation of ``pose``."""
    R = lie.quat_to_rot(lie.pose_quat(pose))
    return torch.cat(
        [R.expand(pts.shape[:1] + (3, 3)),
         -torch.einsum("ij,qjk->qik", R, lie.hat(pts))], dim=-1)


def line_residuals(pose, corners, centroid, d, w):
    """Residual/Jacobian of the point-to-line cost at ``pose`` for frozen
    line fits. Returns (res (Q,3), J (Q,3,6), w)."""
    p_map = _transform(pose, corners)
    P = (torch.eye(3, dtype=corners.dtype, device=corners.device)[None]
         - d[:, :, None] * d[:, None, :])
    res = torch.einsum("qij,qj->qi", P, p_map - centroid)
    J = torch.einsum("qij,qjk->qik", P, _point_jacobian(pose, corners))
    return res, J, w


def plane_fits(pose, surfs, surf_mask, map_surfs, map_mask, cfg: IcpConfig):
    """5-NN plane fits in the surface map at ``pose``: returns
    (normal (Q,3), offset (Q,), w (Q,)) with plane ``n·x + offset = 0``."""
    p_map = _transform(pose, surfs)
    idx, d2 = knn(p_map.contiguous(), surf_mask, map_surfs, map_mask)
    nn = map_surfs[idx]                                   # (Q, K, 3)
    centroid = torch.mean(nn, dim=1)
    dc = nn - centroid[:, None, :]
    cov = torch.einsum("qki,qkj->qij", dc, dc) / KNN_K
    eigval, eigvec = E3.eigh3(cov)                        # ascending
    n = eigvec[..., 0]                                    # smallest → normal
    d_off = -torch.einsum("qi,qi->q", n, centroid)
    fit = torch.abs(torch.einsum("qki,qi->qk", nn, n) + d_off[:, None])
    good_fit = torch.amax(fit, dim=-1) < cfg.plane_fit_tol
    planar = ((eigval[..., 1] > cfg.plane_eig_ratio
               * torch.clamp(eigval[..., 0], min=1e-6))
              & (eigval[..., 1] > cfg.plane_mid_eig_min))
    near = d2[:, -1] < cfg.max_corr_dist ** 2
    dtype = surfs.dtype
    w = surf_mask * good_fit.to(dtype) * planar.to(dtype) * near.to(dtype)
    return n, d_off, w


def plane_residuals(pose, surfs, n, d_off, w):
    """Residual/Jacobian of the point-to-plane cost at ``pose`` for frozen
    plane fits. Returns (res (Q,1), J (Q,1,6), w)."""
    p_map = _transform(pose, surfs)
    res = (torch.einsum("qi,qi->q", n, p_map) + d_off)[:, None]
    J = torch.einsum("qi,qik->qk", n, _point_jacobian(pose, surfs))[:, None, :]
    return res, J, w


def accumulate_normal_eqs(res, J, w):
    """H = Σ w JᵀJ, g = Σ w Jᵀr, cost = Σ w rᵀr. Zero-weight rows are
    zeroed first: an invalid correspondence's residual may be non-finite,
    and 0·inf would poison the sums."""
    ok = (w > 0)[:, None]
    res = torch.where(ok, res, 0.0)
    J = torch.where(ok[..., None], J, 0.0)
    H = torch.einsum("qri,q,qrj->ij", J, w, J)
    g = torch.einsum("qri,q,qr->i", J, w, res)
    cost = torch.einsum("qr,q,qr->", res, w, res)
    return H, g, cost


def degeneracy_projected_step(H, g, cfg: IcpConfig):
    """LOAM's degeneracy-aware solve: eigen-directions of H with eigenvalue
    below ``degen_eigval`` are frozen. Returns (dx, degenerate (6,))."""
    eigval, V = E6.jacobi_eigh(H)
    ok = (eigval > cfg.degen_eigval).to(H.dtype)
    damping = cfg.damping * torch.clamp(
        torch.mean(torch.diagonal(H)), min=1.0)
    dx_proj = -E6.eig_solve(eigval, V, g, damping=damping, keep=ok)
    return dx_proj, 1.0 - ok


class PerturbationDists(NamedTuple):
    """The thesis fork's per-DOF perturbation-sweep correspondence
    distances (OdometryWithHessian dists/dists_surface/dists_corner (6×S)
    and shift_trans/shift_rot (S)). Row d is the mean correspondence
    distance after perturbing the solution pose along DOF d (ρx ρy ρz θx θy
    θz) by each shift; a flat row means the cost ignores that DOF."""

    dists: torch.Tensor          # (6, S) combined mean distance
    dists_corner: torch.Tensor   # (6, S)
    dists_surface: torch.Tensor  # (6, S)
    shift_trans: torch.Tensor    # (S,)
    shift_rot: torch.Tensor      # (S,)


def perturbation_dists(
    pose: torch.Tensor,
    corners: torch.Tensor, corner_mask: torch.Tensor,
    surfs: torch.Tensor, surf_mask: torch.Tensor,
    map_corners: torch.Tensor, map_corner_mask: torch.Tensor,
    map_surfs: torch.Tensor, map_surf_mask: torch.Tensor,
    cfg: IcpConfig = IcpConfig(),
    n_shifts: int = 15,
    max_shift_trans: float = 0.2,
    max_shift_rot: float = 0.2,
) -> PerturbationDists:
    """Sweep the solution pose along each DOF and record how the matched
    correspondence distances grow. The line and plane fits (one k-NN each)
    are taken once, at the solution; the 6×S perturbed poses are then
    evaluated together as one ``(6·S, Q, 3)`` batch. Shifts run over
    0..0.2 (special_graphs.py:37) with ``jnp.linspace``'s values, in
    float64 and cast."""
    dtype, device = pose.dtype, pose.device
    centroid, ldir, wl = line_fits(
        pose, corners, corner_mask, map_corners, map_corner_mask, cfg)
    nrm, d_off, wp = plane_fits(
        pose, surfs, surf_mask, map_surfs, map_surf_mask, cfg)
    nl = torch.clamp(torch.sum(wl), min=1.0)
    np_ = torch.clamp(torch.sum(wp), min=1.0)

    s_t = linspace0(max_shift_trans, n_shifts, dtype, device)
    s_r = linspace0(max_shift_rot, n_shifts, dtype, device)
    mags = torch.cat([s_t.expand(3, n_shifts), s_r.expand(3, n_shifts)])
    xi = (torch.eye(6, dtype=dtype, device=device)[:, None, :]
          * mags[:, :, None]).reshape(6 * n_shifts, 6)
    poses = lie.pose_retract(pose, xi)                     # (6·S, 7)
    q = lie.pose_quat(poses)[:, None, :]
    t = lie.pose_trans(poses)[:, None, :]

    v = lie.quat_rotate(q, corners) + t - centroid          # (6·S, Qc, 3)
    perp = v - ldir * torch.einsum("pqi,qi->pq", v, ldir)[..., None]
    dl = torch.linalg.vector_norm(perp, dim=-1)
    ps = lie.quat_rotate(q, surfs) + t                      # (6·S, Qs, 3)
    dp = torch.abs(torch.einsum("qi,pqi->pq", nrm, ps) + d_off)
    sl = torch.sum(wl * dl, dim=-1)
    sp = torch.sum(wp * dp, dim=-1)
    shape = (6, n_shifts)
    return PerturbationDists(
        dists=((sl + sp) / (nl + np_)).reshape(shape),
        dists_corner=(sl / nl).reshape(shape),
        dists_surface=(sp / np_).reshape(shape),
        shift_trans=s_t, shift_rot=s_r,
    )


def register(
    pose0: torch.Tensor,
    corners: torch.Tensor, corner_mask: torch.Tensor,
    surfs: torch.Tensor, surf_mask: torch.Tensor,
    map_corners: torch.Tensor, map_corner_mask: torch.Tensor,
    map_surfs: torch.Tensor, map_surf_mask: torch.Tensor,
    cfg: IcpConfig = IcpConfig(),
    group=None,
) -> IcpResult:
    """Scan-to-map registration: ``ceil(iters/fit_every)`` correspondence
    rounds (KNN + line/plane fits + one 6×6 eigendecomposition), each
    followed by ``fit_every`` GN steps on the frozen fits.

    With ``final_refresh=False`` the reported Hessian and cost are those of
    the last inner step, evaluated at the pose one update before the final
    one (stale by one, exactly as the JAX version).

    ``group``: a ``torch.distributed`` process group over which the query
    point sets (corners, surfs and their masks) are sharded, the map
    replicated — the counterpart of the JAX version's ``axis_name``. The
    partial normal equations (H, g, cost) are all-reduced over it every GN
    step and ``n_corr`` at the end, so every rank applies the same global
    update and returns the same result."""

    def _reduce(*xs):
        if group is None:
            return xs
        flat = torch.cat([x.reshape(-1) for x in xs])
        dist.all_reduce(flat, group=group)
        out, o = [], 0
        for x in xs:
            out.append(flat[o:o + x.numel()].reshape(x.shape))
            o += x.numel()
        return tuple(out)

    def do_fits(pose):
        lf = line_fits(pose, corners, corner_mask, map_corners,
                       map_corner_mask, cfg)
        pf = plane_fits(pose, surfs, surf_mask, map_surfs, map_surf_mask, cfg)
        return lf, pf

    def normal_eqs(pose, lf, pf):
        rl, Jl, wl = line_residuals(pose, corners, *lf)
        rp, Jp, wp = plane_residuals(pose, surfs, *pf)
        Hl, gl, cl = accumulate_normal_eqs(rl, Jl, wl)
        Hp, gp, cp = accumulate_normal_eqs(rp, Jp, wp)
        return _reduce(Hl + Hp, gl + gp, cl + cp)

    dtype, device = pose0.dtype, pose0.device
    pose = pose0
    H = torch.zeros((6, 6), dtype=dtype, device=device)
    degen = torch.zeros((6,), dtype=dtype, device=device)
    cost = torch.zeros((), dtype=dtype, device=device)
    lf = (torch.zeros((corners.shape[0], 3), dtype=dtype, device=device),
          torch.zeros((corners.shape[0], 3), dtype=dtype, device=device),
          torch.zeros((corners.shape[0],), dtype=dtype, device=device))
    pf = (torch.zeros((surfs.shape[0], 3), dtype=dtype, device=device),
          torch.zeros((surfs.shape[0],), dtype=dtype, device=device),
          torch.zeros((surfs.shape[0],), dtype=dtype, device=device))

    n_rounds = -(-cfg.iters // cfg.fit_every)
    for _ in range(n_rounds):
        lf, pf = do_fits(pose)
        H, g, cost = normal_eqs(pose, lf, pf)
        eigval, V = E6.jacobi_eigh(H, sweeps=cfg.eig_sweeps)
        ok = (eigval > cfg.degen_eigval).to(dtype)
        degen = 1.0 - ok
        damping = cfg.damping * torch.clamp(
            torch.mean(torch.diagonal(H)), min=1.0)

        def solve_retract(pose, g):
            dx = -E6.eig_solve(eigval, V, g, damping=damping, keep=ok)
            return lie.pose_retract(pose, dx)

        pose = solve_retract(pose, g)
        if cfg.fit_every > 1:
            for _ in range(cfg.fit_every - 2):
                _, g, _ = normal_eqs(pose, lf, pf)
                pose = solve_retract(pose, g)
            # The last inner step keeps (H, cost) at its pre-update pose.
            H, g, cost = normal_eqs(pose, lf, pf)
            pose = solve_retract(pose, g)

    if cfg.final_refresh:
        lf, pf = do_fits(pose)
        rl, Jl, wl = line_residuals(pose, corners, *lf)
        rp, Jp, wp = plane_residuals(pose, surfs, *pf)
        Hl, _, cl = accumulate_normal_eqs(rl, Jl, wl)
        Hp, _, cp = accumulate_normal_eqs(rp, Jp, wp)
        hessian, cost, n_corr = _reduce(Hl + Hp, cl + cp,
                                        torch.sum(wl) + torch.sum(wp))
    else:
        # H and cost come from normal_eqs, already reduced.
        hessian = H
        (n_corr,) = _reduce(torch.sum(lf[2]) + torch.sum(pf[2]))
    return IcpResult(pose=pose, hessian=hessian, cost=cost, n_corr=n_corr,
                     degenerate=degen)

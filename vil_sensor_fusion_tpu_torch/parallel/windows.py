"""Keyframe-window sharding of a trajectory smoother: a long pose chain
optimised across the ranks of one mesh axis.

Port of ``vil_sensor_fusion_tpu/parallel/windows.py``:

- the trajectory's N keyframes are split into S contiguous windows of Wl
  states, one window per rank on the chosen axis;
- each Gauss-Newton iteration every rank receives the FIRST state of its
  right neighbour's window (the boundary halo), so it can linearise its
  crossing odometry factor locally. JAX shifts it with a ``ppermute``;
  here the S first states are all-gathered (S·7 numbers) and each rank
  takes its neighbour's;
- each rank Schur-eliminates its interior states onto its two separator
  states (its own first state and the halo): a 12×12 block and gradient;
- the separator blocks are all-gathered (S·(144+12) numbers) and the
  block-tridiagonal separator chain is solved dense, replicated on every
  rank;
- each rank back-substitutes its interior update and retracts.

The result equals the sequential dense GN over all N states up to
summation order. States are SE(3) poses (7-vector, tangent dim 6);
factors are a prior on state 0 and an SE(3) between-factor chain.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from .. import _precision
from ..core import lie
from .mesh import all_gather_cat

D = 6  # tangent dim per keyframe


# ---------------------------------------------------------------------------
# Shared factor linearization
# ---------------------------------------------------------------------------

def _between_residual(pose_i, pose_j, measured):
    """r = log(measured⁻¹ · (i⁻¹ j)) — the convention of
    graph.factors.between_residual."""
    rel = lie.pose_between(pose_i, pose_j)
    return lie.se3_log(lie.pose_compose(lie.pose_inverse(measured), rel))


def _with_value(fn):
    def f(*args):
        r = fn(*args)
        return r, r
    return f


def _linearize_between(pose_i, pose_j, measured):
    """(r (..., 6), A_i (..., 6, 6), A_j (..., 6, 6)) over any leading
    axes: one tangent shared by the batch, whose elements are independent
    (as in graph.factors)."""
    z = torch.zeros((D,), dtype=pose_i.dtype, device=pose_i.device)

    def r_of(di, dj):
        return _between_residual(lie.pose_retract(pose_i, di),
                                 lie.pose_retract(pose_j, dj), measured)

    (A_i, A_j), r = jacfwd(_with_value(r_of), argnums=(0, 1),
                           has_aux=True)(z, z)
    return r, A_i, A_j


def _linearize_prior(pose, prior_pose):
    z = torch.zeros((D,), dtype=pose.dtype, device=pose.device)

    def r_of(d):
        return lie.se3_log(lie.pose_between(prior_pose,
                                            lie.pose_retract(pose, d)))

    A, r = jacfwd(_with_value(r_of), has_aux=True)(z)
    return r, A


def _assemble_chain(poses, meas, infos, prior_pose, prior_info,
                    has_prior: float):
    """Dense normal equations of a W-state window: prior on state 0 (scaled
    by ``has_prior``) + between factors (i, i+1) for i < W-1. Returns
    (H (W·6, W·6), b (W·6,))."""
    W = poses.shape[0]
    H = torch.zeros((W * D, W * D), dtype=poses.dtype, device=poses.device)
    b = torch.zeros((W * D,), dtype=poses.dtype, device=poses.device)

    r0, A0 = _linearize_prior(poses[0], prior_pose)
    H[:D, :D] += A0.T @ prior_info @ A0 * has_prior
    b[:D] += A0.T @ (prior_info @ r0) * has_prior

    r, A_i, A_j = _linearize_between(poses[:-1], poses[1:], meas)
    Hii = torch.einsum("sri,srq,sqk->sik", A_i, infos, A_i)
    Hij = torch.einsum("sri,srq,sqk->sik", A_i, infos, A_j)
    Hjj = torch.einsum("sri,srq,sqk->sik", A_j, infos, A_j)
    bi = torch.einsum("sri,srq,sq->si", A_i, infos, r)
    bj = torch.einsum("sri,srq,sq->si", A_j, infos, r)
    for s in range(W - 1):
        o = s * D
        H[o:o + D, o:o + D] += Hii[s]
        H[o:o + D, o + D:o + 2 * D] += Hij[s]
        H[o + D:o + 2 * D, o:o + D] += Hij[s].T
        H[o + D:o + 2 * D, o + D:o + 2 * D] += Hjj[s]
        b[o:o + D] += bi[s]
        b[o + D:o + 2 * D] += bj[s]
    return H, b


def _solve_or_nan(A, B):
    """A⁻¹B, NaN where A is singular (``jnp.linalg.solve``'s behaviour;
    ``torch.linalg.solve`` raises there)."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where(info == 0, X, torch.nan)


def _damped_solve(H, b, lam: float):
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = (H * s[:, None] * s[None, :]
          + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device))
    return s * _solve_or_nan(Hs, s * b)


# ---------------------------------------------------------------------------
# Sequential reference
# ---------------------------------------------------------------------------

def solve_sequential(
    poses: torch.Tensor,        # (N, 7) initial estimates
    meas: torch.Tensor,         # (N-1, 7) odometry between measurements
    infos: torch.Tensor,        # (N-1, 6, 6)
    prior_pose: torch.Tensor,   # (7,)
    prior_info: torch.Tensor,   # (6, 6)
    iters: int = 5,
    damping: float = 1e-9,
) -> torch.Tensor:
    """Dense GN over the whole chain in one process — the ground truth the
    sharded solver must match."""
    _precision.require_full_f32()
    x = poses
    for _ in range(iters):
        H, b = _assemble_chain(x, meas, infos, prior_pose, prior_info, 1.0)
        dx = -_damped_solve(H, b, damping)
        x = lie.pose_retract(x, dx.reshape(-1, D))
    return x


# ---------------------------------------------------------------------------
# Sharded solver
# ---------------------------------------------------------------------------

def _window_iteration(x_w, meas_w, infos_w, cross_meas, cross_info,
                      prior_pose, prior_info, group, s_idx: int, S: int,
                      damping: float):
    """One distributed GN iteration for this rank's window.

    x_w (Wl, 7) — owned states; meas_w/infos_w — the Wl-1 interior
    factors; cross_meas/cross_info — the factor from this window's LAST
    state to the next window's FIRST state (zero information on the last
    rank)."""
    dtype, device = x_w.dtype, x_w.device
    Wl = x_w.shape[0]

    # --- halo exchange: the right neighbour's FIRST state -----------------
    firsts = all_gather_cat(x_w[:1], group)                 # (S, 7)
    halo = firsts[(s_idx + 1) % S]

    # --- local normal equations over (Wl + 1) states ----------------------
    poses_loc = torch.cat([x_w, halo[None]], dim=0)
    meas_loc = torch.cat([meas_w, cross_meas[None]], dim=0)
    cinfo = cross_info * (0.0 if s_idx == S - 1 else 1.0)
    infos_loc = torch.cat([infos_w, cinfo[None]], dim=0)
    H, b = _assemble_chain(poses_loc, meas_loc, infos_loc, prior_pose,
                           prior_info, 1.0 if s_idx == 0 else 0.0)

    # --- Schur-eliminate the interior onto (own first, halo) --------------
    sep = torch.cat([torch.arange(D), torch.arange(Wl * D, (Wl + 1) * D)]
                    ).to(device)
    inn = torch.arange(D, Wl * D, device=device)
    Hss, Hsi, Hii = H[sep][:, sep], H[sep][:, inn], H[inn][:, inn]
    bs, bi = b[sep], b[inn]
    si = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hii), min=1e-12))
    Hii_s = (Hii * si[:, None] * si[None, :]
             + 1e-9 * torch.eye(Hii.shape[0], dtype=dtype, device=device))
    rhs = torch.cat([Hsi.T * si[:, None], (bi * si)[:, None]], dim=1)
    K = si[:, None] * _solve_or_nan(Hii_s, rhs)           # (nint, 2D+1)
    S_blk = Hss - Hsi @ K[:, :-1]                           # (2D, 2D)
    g_blk = bs - Hsi @ K[:, -1]                             # (2D,)

    # --- gather + solve the separator chain (replicated) ------------------
    S_all = all_gather_cat(S_blk[None], group)              # (S, 2D, 2D)
    g_all = all_gather_cat(g_blk[None], group)              # (S, 2D)
    # Separator s's unknowns: (sep_s, sep_{s+1}); the last window's right
    # separator is its halo slot, a dummy unknown with identity information
    # and zero gradient, so its update is zero.
    nsep = S + 1
    Hsep = torch.zeros((nsep * D, nsep * D), dtype=dtype, device=device)
    gsep = torch.zeros((nsep * D,), dtype=dtype, device=device)
    for sdev in range(S):
        o = sdev * D
        Hsep[o:o + 2 * D, o:o + 2 * D] += S_all[sdev]
        gsep[o:o + 2 * D] += g_all[sdev]
    o = S * D
    Hsep[o:o + D, o:o + D] += torch.eye(D, dtype=dtype, device=device)
    dsep = -_damped_solve(Hsep, gsep, damping)

    my_sep = dsep[s_idx * D:s_idx * D + 2 * D]
    # --- back-substitute the interior --------------------------------------
    # Hii dxi + Hsiᵀ dxs = -bi  ⇒  dxi = -(K[:, -1] + K[:, :-1] @ dxs).
    dint = -(K[:, -1] + K[:, :-1] @ my_sep)
    dx_w = torch.cat([my_sep[:D], dint]).reshape(Wl, D)
    return lie.pose_retract(x_w, dx_w)


def solve_sharded(
    mesh,
    axis_name: str,
    poses: torch.Tensor,        # (N, 7) with N = S · Wl
    meas: torch.Tensor,         # (N-1, 7)
    infos: torch.Tensor,        # (N-1, 6, 6)
    prior_pose: torch.Tensor,
    prior_info: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-9,
) -> torch.Tensor:
    """Distributed GN over the keyframe chain: windows split over the ranks
    of ``axis_name``, halo exchange + separator Schur per iteration. Every
    rank passes the whole chain and gets the whole solution (N, 7) back.
    Matches :func:`solve_sequential` up to summation order."""
    _precision.require_full_f32()
    S, s_idx = mesh.size(axis_name), mesh.index(axis_name)
    group = mesh.group(axis_name)
    N = poses.shape[0]
    if N % S:
        raise ValueError(f"trajectory length {N} must tile the window "
                         f"axis of size {S}")
    Wl = N // S
    dev = mesh.device
    poses, meas, infos, prior_pose, prior_info = (
        t.to(dev) for t in (poses, meas, infos, prior_pose, prior_info))
    dtype = poses.dtype

    # Window s owns states [s·Wl, (s+1)·Wl); its interior factors are
    # meas[s·Wl : s·Wl + Wl-1]; its crossing factor is meas[(s+1)·Wl - 1]
    # (absent for the last window — padded with identity, zero info).
    meas_pad = torch.cat([meas, lie.pose_identity(dtype, dev)[None]], dim=0)
    infos_pad = torch.cat([infos, torch.zeros((1, D, D), dtype=dtype,
                                              device=dev)], dim=0)
    x_w = poses.reshape(S, Wl, 7)[s_idx]
    meas_w = meas_pad.reshape(S, Wl, 7)[s_idx, :-1]
    infos_w = infos_pad.reshape(S, Wl, D, D)[s_idx, :-1]
    cross_meas = meas_pad.reshape(S, Wl, 7)[s_idx, -1]
    cross_info = infos_pad.reshape(S, Wl, D, D)[s_idx, -1]
    for _ in range(iters):
        x_w = _window_iteration(x_w, meas_w, infos_w, cross_meas, cross_info,
                                prior_pose, prior_info, group, s_idx, S,
                                damping)
    return all_gather_cat(x_w, group)

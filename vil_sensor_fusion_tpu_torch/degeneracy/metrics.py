"""Degeneracy-detection metric library over batched matrices.

Port of ``vil_sensor_fusion_tpu/degeneracy/metrics.py``. Every function
takes batched symmetric matrices ``(..., n, n)`` (covariances or
Gauss-Newton Hessians, 6×6 or their 3×3 sub-blocks) and returns batched
scalars ``(...)``.

The reference quirks the JAX module documents are kept:

- ``condition_number`` is the NEGATED condition number (low = degenerate);
  ``condition_cov`` is the positive one.
- ``jensen_bregman`` is the real JBLD divergence; ``jensen_bregman_ref`` is
  the reference's literal formula with a raw determinant.
- ``correlation_matrix_distance`` is the real correlation-matrix distance.
- ``kullback_leibler_0cov`` scores against an identity covariance.

Failure modes follow ``jnp.linalg``, because the NaN and ±inf pattern of a
score series is part of the result (the first sweep's Hessian is all
zeros). ``torch.linalg.inv`` raises on a singular matrix where ``jnp`` runs
its LU solve through the zero pivot: :func:`_inv` runs the same solve
(``lu_factor_ex`` + ``lu_solve``). ``eigvalsh`` and ``svdvals`` raise on
non-finite input where ``jnp`` returns NaN: :func:`_finite_only` evaluates
the finite matrices and writes all NaN for the others, which is what
``jnp`` gives for the non-finite matrices a run makes (the NaN inverse of
the zero Hessian, a matrix with an inf entry).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

_E = 2.718281828459045
_TWO_PI_E = 2.0 * math.pi * _E


def _logabsdet(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.slogdet(m).logabsdet


def _inv(m: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.inv``: an LU factorisation with partial pivoting, then
    two triangular solves against the identity, run through a zero pivot
    without a check (``lu_factor_ex`` does not raise)."""
    LU, piv, _ = torch.linalg.lu_factor_ex(m)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return torch.linalg.lu_solve(LU, piv, eye.expand(m.shape))


def _finite_only(fn: Callable, m: torch.Tensor) -> torch.Tensor:
    """``fn`` (an eigenvalue or singular-value routine, ``(..., n, n)`` →
    ``(..., n)``) on the finite matrices of the batch; all NaN for a matrix
    with a non-finite entry. A zero comes out as +0: the card's batched
    ``eigvalsh`` gives the zero Hessian's eigenvalues either sign from one
    call to the next."""
    ok = torch.isfinite(m).all(dim=-1).all(dim=-1)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    vals = fn(torch.where(ok[..., None, None], m, eye)) + 0.0
    return torch.where(ok[..., None], vals, torch.nan)


def _eigvalsh(m: torch.Tensor) -> torch.Tensor:
    return _finite_only(torch.linalg.eigvalsh, m)


def _svdvals(m: torch.Tensor) -> torch.Tensor:
    return _finite_only(torch.linalg.svdvals, m)


def _dim(m: torch.Tensor) -> float:
    return float(m.shape[-1])


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


# ---------------------------------------------------------------------------
# Single-matrix metrics
# ---------------------------------------------------------------------------

def d_opt(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """D-optimality: exp(logdet(M)/n)."""
    return torch.exp(_logabsdet(mat_now) / _dim(mat_now))


def a_opt(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """A-optimality: trace."""
    return _trace(mat_now)


def e_opt(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """E-optimality: minimum eigenvalue."""
    return torch.amin(_eigvalsh(mat_now), dim=-1)


def max_eigen(mat_now: torch.Tensor, **_) -> torch.Tensor:
    return torch.amax(_eigvalsh(mat_now), dim=-1)


def differential_entropy(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """0.5·log((2πe)^n · det(M))."""
    n = _dim(mat_now)
    return 0.5 * (n * math.log(_TWO_PI_E) + _logabsdet(mat_now))


def condition_number(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """NEGATED 2-norm condition number (reference polarity: low =
    degenerate)."""
    return -condition_cov(mat_now)


def condition_cov(mat_now: torch.Tensor, **_) -> torch.Tensor:
    s = _svdvals(mat_now)
    return s[..., 0] / s[..., -1]


def norm_frobenius(mat_now: torch.Tensor, **_) -> torch.Tensor:
    return torch.sqrt(torch.sum(mat_now * mat_now, dim=(-2, -1)))


def norm_nuclear(mat_now: torch.Tensor, **_) -> torch.Tensor:
    return torch.sum(_svdvals(mat_now), dim=-1)


def norm_1(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """Induced 1-norm: max column absolute sum."""
    return torch.amax(torch.sum(torch.abs(mat_now), dim=-2), dim=-1)


def norm_2(mat_now: torch.Tensor, **_) -> torch.Tensor:
    """Spectral norm: largest singular value."""
    return torch.amax(_svdvals(mat_now), dim=-1)


# ---------------------------------------------------------------------------
# Ratio variants: metric(M_now · M_prev⁻¹)
# ---------------------------------------------------------------------------

def _ratio(mat_now, mat_prev):
    return mat_now @ _inv(mat_prev)


def _sym(r):
    return 0.5 * (r + r.transpose(-1, -2))


def d_opt_ratio(mat_now, mat_prev, **_):
    r = _ratio(mat_now, mat_prev)
    return torch.exp(_logabsdet(r) / _dim(r))


def a_opt_ratio(mat_now, mat_prev, **_):
    return _trace(_ratio(mat_now, mat_prev))


def e_opt_ratio(mat_now, mat_prev, **_):
    # The ratio is similar to the SPD P⁻¹ᐟ² N P⁻¹ᐟ²: its eigenvalues are
    # real, and those of its symmetric part are taken.
    return torch.amin(_eigvalsh(_sym(_ratio(mat_now, mat_prev))), dim=-1)


def max_eigen_ratio(mat_now, mat_prev, **_):
    return torch.amax(_eigvalsh(_sym(_ratio(mat_now, mat_prev))), dim=-1)


def norm_frobenius_ratio(mat_now, mat_prev, **_):
    return norm_frobenius(_ratio(mat_now, mat_prev))


def norm_nuclear_ratio(mat_now, mat_prev, **_):
    return norm_nuclear(_ratio(mat_now, mat_prev))


def norm_1_ratio(mat_now, mat_prev, **_):
    return norm_1(_ratio(mat_now, mat_prev))


def norm_2_ratio(mat_now, mat_prev, **_):
    return norm_2(_ratio(mat_now, mat_prev))


# ---------------------------------------------------------------------------
# Divergences between consecutive distributions
# ---------------------------------------------------------------------------

def jensen_bregman(mat_now, mat_prev, **_):
    """Jensen-Bregman LogDet divergence:
    logdet((A+B)/2) − ½·logdet(A·B)."""
    return (_logabsdet(0.5 * (mat_now + mat_prev))
            - 0.5 * _logabsdet(mat_now @ mat_prev))


def jensen_bregman_ref(mat_now, mat_prev, **_):
    """The reference's literal computation (raw det in the second term)."""
    return (_logabsdet(0.5 * (mat_now + mat_prev))
            - 0.5 * torch.linalg.det(mat_now @ mat_prev))


def correlation_matrix_distance(mat_now, mat_prev, **_):
    """CMD(A,B) = 1 − tr(corr(A)·corr(B)) / (‖corr(A)‖_F ‖corr(B)‖_F)."""
    def corr(m):
        d = torch.sqrt(torch.clamp(torch.diagonal(m, dim1=-2, dim2=-1),
                                   min=1e-30))
        return m / (d[..., :, None] * d[..., None, :])

    ca, cb = corr(mat_now), corr(mat_prev)
    tr = _trace(ca @ cb)
    return 1.0 - tr / (norm_frobenius(ca) * norm_frobenius(cb))


def kullback_leibler(mat_now, mat_prev, pose_now=None, pose_prev=None, **_):
    """Gaussian KL(N(u1,E1) ‖ N(u2,E2)) with E1=prev, E2=now."""
    n = _dim(mat_now)
    E1, E2 = mat_prev, mat_now
    E2i = _inv(E2)
    a = _trace(E2i @ E1) - n
    if pose_now is None:
        b = 0.0
    else:
        du = pose_prev - pose_now
        b = torch.einsum("...i,...ij,...j->...", du, E2i, du)
    c = torch.log(torch.abs(torch.linalg.det(E2))
                  / torch.abs(torch.linalg.det(E1)))
    return 0.5 * (a + b + c)


def kullback_leibler_0pose(mat_now, mat_prev, **_):
    return kullback_leibler(mat_now, mat_prev)


def kullback_leibler_0cov(mat_now, mat_prev, **_):
    """KL against an identity-covariance reference (the reference passes a
    zero E1, which is always singular)."""
    eye = torch.eye(mat_now.shape[-1], dtype=mat_now.dtype,
                    device=mat_now.device)
    return kullback_leibler(mat_now, eye.expand(mat_now.shape))


# ---------------------------------------------------------------------------
# Correspondence-distance slope metrics (LOAM perturbation sweep)
# ---------------------------------------------------------------------------

def dist_slope(dists: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Least-squares slope of correspondence distance against perturbation
    shift (scipy.stats.linregress's slope) over the last axis."""
    dx = shifts - torch.mean(shifts, dim=-1, keepdim=True)
    dy = dists - torch.mean(dists, dim=-1, keepdim=True)
    return (torch.sum(dx * dy, dim=-1)
            / torch.clamp(torch.sum(dx * dx, dim=-1), min=1e-30))


def dist_slopes_6dof(dists_6k: torch.Tensor, shifts_trans: torch.Tensor,
                     shifts_rot: torch.Tensor) -> torch.Tensor:
    """All six dist_slope_{tx,ty,tz,rx,ry,rz} at once: ``dists_6k``
    (..., 6, K) per perturbed DOF, shifts (..., K)."""
    st = shifts_trans[..., None, :].expand(dists_6k[..., :3, :].shape)
    sr = shifts_rot[..., None, :].expand(dists_6k[..., 3:, :].shape)
    return torch.cat([dist_slope(dists_6k[..., :3, :], st),
                      dist_slope(dists_6k[..., 3:, :], sr)], dim=-1)


# Registry mirroring the reference's ``degen_funcs`` export list.
METRICS = {
    "d_opt": d_opt,
    "d_opt_ratio": d_opt_ratio,
    "a_opt": a_opt,
    "a_opt_ratio": a_opt_ratio,
    "e_opt": e_opt,
    "e_opt_ratio": e_opt_ratio,
    "max_eigen": max_eigen,
    "max_eigen_ratio": max_eigen_ratio,
    "jensen_bregman": jensen_bregman,
    "jensen_bregman_ref": jensen_bregman_ref,
    "correlation_matrix_distance": correlation_matrix_distance,
    "kullback_leibler": kullback_leibler,
    "kullback_leibler_0pose": kullback_leibler_0pose,
    "kullback_leibler_0cov": kullback_leibler_0cov,
    "differential_entropy": differential_entropy,
    "condition_number": condition_number,
    "condition_cov": condition_cov,
    "norm_frobenius": norm_frobenius,
    "norm_frobenius_ratio": norm_frobenius_ratio,
    "norm_nuclear": norm_nuclear,
    "norm_nuclear_ratio": norm_nuclear_ratio,
    "norm_1": norm_1,
    "norm_1_ratio": norm_1_ratio,
    "norm_2": norm_2,
    "norm_2_ratio": norm_2_ratio,
}

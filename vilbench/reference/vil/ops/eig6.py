"""Fixed-sweep cyclic Jacobi eigendecomposition for small symmetric
matrices (the 6×6 ICP Hessians).

Port of ``vil_sensor_fusion_tpu/ops/eig6.py``. The sweep count is fixed, as
in the JAX package: the registration's degeneracy projection and the
odometry covariance take the eigenbasis after exactly ``sweeps`` sweeps,
whatever the remaining off-diagonal mass.
"""

from __future__ import annotations

import torch


def jacobi_eigh(A: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric (..., n, n), n small.

    Returns (eigenvalues ascending (..., n), eigenvectors (..., n, n) as
    columns). Every sweep applies all n(n−1)/2 rotations in the same cyclic
    order as the JAX version. Works on a private copy of ``A``."""
    n = A.shape[-1]
    A = A.clone()
    # V carries A's lane axis under ``torch.func.vmap`` (a fresh identity
    # would not take the lane-dependent columns written into it below).
    V = torch.zeros_like(A) + torch.eye(n, dtype=A.dtype, device=A.device)
    eps = 1e-30

    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = A[..., p, q]
                app = A[..., p, p]
                aqq = A[..., q, q]
                tiny = torch.abs(apq) < eps
                # Stable rotation: t = sign(θ)/(|θ|+sqrt(θ²+1)),
                # θ = (aqq−app)/(2 apq); c = 1/sqrt(t²+1), s = t·c.
                theta = (aqq - app) / (2.0 * torch.where(tiny, eps, apq))
                t = torch.sign(theta) / (torch.abs(theta)
                                         + torch.sqrt(theta * theta + 1.0))
                t = torch.where(tiny, 0.0, t)
                c = (1.0 / torch.sqrt(t * t + 1.0))[..., None]
                s = t[..., None] * c

                # Gᵀ A G touches rows/cols p,q only. The right-hand sides
                # are computed before each write, so no aliasing.
                rp, rq = A[..., p, :], A[..., q, :]
                A[..., p, :], A[..., q, :] = c * rp - s * rq, s * rp + c * rq
                cp, cq = A[..., :, p], A[..., :, q]
                A[..., :, p], A[..., :, q] = c * cp - s * cq, s * cp + c * cq
                vp, vq = V[..., :, p], V[..., :, q]
                V[..., :, p], V[..., :, q] = c * vp - s * vq, s * vp + c * vq

    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w_sorted = torch.gather(w, -1, order)
    V_sorted = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w_sorted, V_sorted


def eig_solve(w: torch.Tensor, V: torch.Tensor, g: torch.Tensor,
              damping: torch.Tensor | float = 0.0,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """x = V diag(keep/(w+damping)) Vᵀ g — the damped (optionally
    eigen-projected) solve of H x = g given H's eigendecomposition."""
    coeff = 1.0 / (w + damping)
    if keep is not None:
        coeff = coeff * keep
    return torch.einsum("...ij,...j,...kj,...k->...i", V, coeff, V, g)

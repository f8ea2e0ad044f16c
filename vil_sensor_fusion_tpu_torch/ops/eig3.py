"""Closed-form eigendecomposition of batched symmetric 3×3 matrices.

Port of ``vil_sensor_fusion_tpu/ops/eig3.py``: Smith's trigonometric method
for the eigenvalues and cross products of ``A − λI`` rows for the
eigenvectors, with the same fixed fallbacks where eigenvalues coalesce.
``torch.linalg.eigh`` is deliberately not used: its iterative solver picks
other eigenvector signs and other vectors in the degenerate corner, which
the ICP eligibility gates and the tests would see.

Use sites: ``frontends/lidar/icp.py`` line_fits / plane_fits.
"""

from __future__ import annotations

import torch

from ..core.lie import _cross

_TWO_PI_3 = 2.0943951023931953  # 2π/3


def eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending (..., 3)."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-20)
    # det(B)/2 with B = (A - qI)/p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    e_mid = 3.0 * q - e_max - e_min
    return torch.stack([e_min, e_mid, e_max], dim=-1)


def _unit_or(v: torch.Tensor, axis: int) -> torch.Tensor:
    """v / ‖v‖, or the unit vector along ``axis`` where ‖v‖ ≤ 1e-20 (the
    fixed fallback for fully degenerate rows, eig3.py:78-79 and :94-96)."""
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., axis].fill_(1.0)
    return torch.where(nrm > 1e-20, v / torch.clamp(nrm, min=1e-20), fallback)


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric (..., 3, 3) A for eigenvalue lam: the
    null direction of (A − λI), taken as the largest cross product of its
    rows (branch-free; e_x for fully degenerate rows)."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0 = M[..., 0, :]
    r1 = M[..., 1, :]
    r2 = M[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (~best12) & (n02 >= n01)
    v = torch.where(best12[..., None], c12,
                    torch.where(best02[..., None], c02, c01))
    return _unit_or(v, 0)


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues ascending (..., 3) and eigenvectors (..., 3, 3) with
    ``v[..., :, i]`` the i-th eigenvector — closed form, no iteration."""
    w = eigvals3(A)
    v_min = _eigvec(A, w[..., 0])
    v_max = _eigvec(A, w[..., 2])
    # Middle vector: orthogonal complement (exact for distinct eigenvalues;
    # degenerate cases are gated out by the callers), e_y as the fallback.
    v_mid = _unit_or(_cross(v_max, v_min), 1)
    V = torch.stack([v_min, v_mid, v_max], dim=-1)
    return w, V

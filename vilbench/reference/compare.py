"""The numbers that decide ``correct``: the gaps between what the timed path
produced and what the reference works out from the same inputs.

Each function takes the program's tensor and the reference's (any device,
any leading axes) and returns one float, the worst over every entry. Where
one side is finite and the other not, the gap is :data:`MISMATCH`; where
both are non-finite alike, that entry counts as equal.
"""

from __future__ import annotations

import torch

MISMATCH = 1e9      # a gap no sound run comes near, standing for "differs"


def _pair(a, b):
    a = torch.as_tensor(a).detach().to("cpu", torch.float64)
    b = torch.as_tensor(b).detach().to("cpu", torch.float64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return a, b


def _finite_mismatch(a, b) -> bool:
    return bool((torch.isfinite(a) != torch.isfinite(b)).any())


def trans_gap(a, b) -> float:
    """Largest distance (m) between the translations of two pose arrays
    (…, 7), quaternion first, translation last."""
    a, b = _pair(a, b)
    ta, tb = a[..., 4:7], b[..., 4:7]
    if _finite_mismatch(ta, tb):
        return MISMATCH
    ok = torch.isfinite(ta).all(-1) & torch.isfinite(tb).all(-1)
    d = torch.linalg.norm(ta - tb, dim=-1)[ok]
    return float(d.max()) if d.numel() else 0.0


def rel_gap(a, b, block: int = 2) -> float:
    """Largest ‖a − b‖ / ‖b‖ over the trailing ``block`` axes (Frobenius
    norms), the absolute gap where ‖b‖ is 0."""
    a, b = _pair(a, b)
    if _finite_mismatch(a, b):
        return MISMATCH
    fin = torch.isfinite(a) & torch.isfinite(b)
    a, b = torch.where(fin, a, 0.0), torch.where(fin, b, 0.0)
    dims = tuple(range(-block, 0))
    num = torch.linalg.vector_norm(a - b, dim=dims)
    den = torch.linalg.vector_norm(b, dim=dims)
    r = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), num)
    return float(r.max()) if r.numel() else 0.0


def count_gap(a, b) -> float:
    """Largest |a − b| / max(|b|, 1) of two count arrays."""
    a, b = _pair(a, b)
    if _finite_mismatch(a, b):
        return MISMATCH
    r = (a - b).abs() / b.abs().clamp_min(1.0)
    r = r[torch.isfinite(r)]
    return float(r.max()) if r.numel() else 0.0


def mismatches(a, b) -> int:
    """How many entries of two arrays differ (a NaN on both sides counts
    as equal)."""
    a, b = _pair(a, b)
    return int((~((a == b) | (a.isnan() & b.isnan()))).sum())


def per_entry_rel_gap(a, b, block: int = 2) -> list[float]:
    """:func:`rel_gap` of each entry over the leading axes, as a list."""
    a, b = _pair(a, b)
    lead = a.shape[:-block]
    a = a.reshape((-1,) + a.shape[len(lead):])
    b = b.reshape((-1,) + b.shape[len(lead):])
    return [rel_gap(x, y, block) for x, y in zip(a, b)]


def per_entry_count_gap(a, b) -> list[float]:
    a, b = _pair(a, b)
    return [count_gap(x, y) for x, y in zip(a.reshape(-1), b.reshape(-1))]


def readings(prog, ref) -> dict:
    """One unit's numbers: ``prog`` and ``ref`` each hold ``vio``,
    ``lidar`` and ``fused`` as the estimator returns them, with the same
    leading axes. A number ending in ``_median`` is a list, one value per
    sweep, that the judge pools over every unit compared and takes the
    median of."""
    lp, lr = prog["lidar"], ref["lidar"]
    return dict(
        vio_gap_m=trans_gap(prog["vio"].pose, ref["vio"].pose),
        hessian_gap_median=per_entry_rel_gap(lp.hessian, lr.hessian),
        ncorr_gap=count_gap(lp.n_corr, lr.n_corr),
        ncorr_gap_median=per_entry_count_gap(lp.n_corr, lr.n_corr),
        fused_gap_m=trans_gap(prog["fused"].poses, ref["fused"].poses),
    )

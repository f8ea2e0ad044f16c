"""Degeneracy gating over batched 6×6 ICP Hessians.

Port of ``vil_sensor_fusion_tpu/degeneracy/gate.py``:

1. The thesis's final log-det gate (degerate_odometry_filter.cpp:29-48):
   :func:`logdet_gate`, the drop decision a 0/1 weight computed on the
   device.
2. The experimental score node (degeneracy_detection.py): named metrics of
   :mod:`.metrics` on the all/trans/rot sub-blocks of a trajectory's
   matrices, with first-difference derivatives (:func:`score_series`), and
   the Youden-J threshold calibration from labeled windows
   (:func:`calibrate_threshold`).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import torch

from . import metrics as M


class GateConfig(NamedTuple):
    """Thresholds of fusion_params.yaml:35-36. ``normalize_per_corr``
    scores log det(H_block / n_corr), the information per correspondence."""

    rot_threshold: float = 11.5
    trans_threshold: float = 28.9
    normalize_per_corr: bool = False


class GateResult(NamedTuple):
    rot_d_opt: torch.Tensor     # log det of the 3x3 rotation Hessian block
    trans_d_opt: torch.Tensor   # log det of the 3x3 translation Hessian block
    keep: torch.Tensor          # 1.0 = pass, 0.0 = drop (batched)
    valid: torch.Tensor         # 1.0 = scores finite


def _logdet3(m: torch.Tensor) -> torch.Tensor:
    """log det of batched 3x3 blocks, closed form (cofactor expansion);
    non-positive determinants (the empty first-sweep Hessian) map to -inf."""
    det = (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                           - m[..., 1, 2] * m[..., 2, 1])
           - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                             - m[..., 1, 2] * m[..., 2, 0])
           + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                             - m[..., 1, 1] * m[..., 2, 0]))
    return torch.where(det > 0, torch.log(torch.clamp(det, min=1e-30)),
                       -torch.inf)


def logdet_gate(
    hessian: torch.Tensor,
    cfg: GateConfig = GateConfig(),
    n_corr: torch.Tensor | None = None,
) -> GateResult:
    """Gate batched 6x6 Hessians (rho/theta order: translation block
    [0:3,0:3], rotation block [3:6,3:6]) of any leading axes: a drive's
    (T, 6, 6), or B lanes' (B, T, 6, 6) with ``n_corr`` (B, T)."""
    ld_rot = _logdet3(hessian[..., 3:6, 3:6])
    ld_trans = _logdet3(hessian[..., 0:3, 0:3])
    if cfg.normalize_per_corr:
        if n_corr is None:
            raise ValueError("normalize_per_corr requires n_corr")
        shift = 3.0 * torch.log(torch.clamp(n_corr, min=1.0))
        ld_rot = ld_rot - shift
        ld_trans = ld_trans - shift
    keep = (ld_rot >= cfg.rot_threshold) & (ld_trans >= cfg.trans_threshold)
    valid = torch.isfinite(ld_rot) & torch.isfinite(ld_trans)
    return GateResult(rot_d_opt=ld_rot, trans_d_opt=ld_trans,
                      keep=keep.to(hessian.dtype),
                      valid=valid.to(hessian.dtype))


def calibrate_threshold(
    scores: torch.Tensor,
    degenerate: torch.Tensor,
) -> torch.Tensor:
    """The gate threshold that maximises Youden's J (TPR − FPR) when every
    score below it is dropped.

    Args:
      scores: (T,) gate scores (lower = more degenerate).
      degenerate: (T,) bool/0-1 labels (1 = inside a degenerate window).

    Returns the scalar threshold (drop iff score < threshold). Non-finite
    scores count for neither class; the sort is stable (NaN last), as
    ``jnp.argsort``, and J is formed in float64 so the first best cut is
    the one JAX picks.
    """
    lab = degenerate.to(torch.bool)
    finite = torch.isfinite(scores)
    n_pos = torch.clamp(torch.sum(lab & finite), min=1).double()
    n_neg = torch.clamp(torch.sum(~lab & finite), min=1).double()
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    l_sorted = lab[order] & finite[order]
    h_sorted = (~lab[order]) & finite[order]
    # Dropping everything <= s_sorted[i]:
    tp = torch.cumsum(l_sorted, dim=0)          # degenerate correctly dropped
    fp = torch.cumsum(h_sorted, dim=0)          # healthy wrongly dropped
    best = torch.argmax(tp / n_pos - fp / n_neg)
    # Threshold just above the best cut (midpoint to the next score).
    s_next = torch.cat([s_sorted[1:], s_sorted[-1:] + 1.0])
    return 0.5 * (s_sorted[best] + s_next[best])


class DegeneracyScores(NamedTuple):
    """Per-metric score streams over a trajectory (the DegeneracyScore msg
    fields)."""

    score_all: torch.Tensor        # (T,)
    score_trans: torch.Tensor      # (T,)
    score_rot: torch.Tensor        # (T,)
    derivative_all: torch.Tensor   # (T,) first difference (prev = 0 at t=0)
    derivative_trans: torch.Tensor
    derivative_rot: torch.Tensor


def _diff0(x: torch.Tensor) -> torch.Tensor:
    """score[t] - score[t-1] with score[-1] = 0 (the node's init state)."""
    return x - torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def score_series(
    names: Sequence[str],
    mats: torch.Tensor,
    poses: torch.Tensor | None = None,
) -> Mapping[str, DegeneracyScores]:
    """Evaluate named metrics over a trajectory of 6x6 matrices, on their
    device.

    Args:
      names: metric names from :data:`metrics.METRICS`.
      mats: (T, 6, 6) covariance or Hessian series.
      poses: optional (T, 6) pose series (x,y,z,roll,pitch,yaw) for the
        KL-style metrics.

    Returns {name: DegeneracyScores}. mat_prev / pose_prev are the previous
    element (identity / zeros at t=0, the node's init state).
    """
    T = mats.shape[0]
    eye = torch.eye(6, dtype=mats.dtype, device=mats.device)[None]
    prev = torch.cat([eye, mats[:-1]], dim=0)
    if poses is None:
        poses = torch.zeros((T, 6), dtype=mats.dtype, device=mats.device)
    pose_prev = torch.cat([torch.zeros_like(poses[:1]), poses[:-1]], dim=0)

    blocks = {
        "all": (mats, prev, poses, pose_prev),
        "trans": (mats[:, 0:3, 0:3], prev[:, 0:3, 0:3],
                  poses[:, 0:3], pose_prev[:, 0:3]),
        "rot": (mats[:, 3:6, 3:6], prev[:, 3:6, 3:6],
                poses[:, 3:6], pose_prev[:, 3:6]),
    }
    out = {}
    for name in names:
        fn = M.METRICS[name]
        s = {k: fn(mat_now=mn, mat_prev=mp, pose_now=pn, pose_prev=pp)
             for k, (mn, mp, pn, pp) in blocks.items()}
        out[name] = DegeneracyScores(
            score_all=s["all"], score_trans=s["trans"], score_rot=s["rot"],
            derivative_all=_diff0(s["all"]),
            derivative_trans=_diff0(s["trans"]),
            derivative_rot=_diff0(s["rot"]),
        )
    return out

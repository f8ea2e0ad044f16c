"""The thesis's final log-det degeneracy gate
(degerate_odometry_filter.cpp:29-48) over batched 6×6 ICP Hessians.

Port of the gate half of ``vil_sensor_fusion_tpu/degeneracy/gate.py``; the
metric library, ``score_series`` and ``calibrate_threshold`` are not ported
yet. The drop decision is a 0/1 weight, computed on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
    [0:3,0:3], rotation block [3:6,3:6])."""
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

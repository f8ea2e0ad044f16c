"""Brute-force metric/error correlation search — the batched equivalent of
vil_fusion/python/find_correlations.py: every (metric × sub-block ×
transform) series against every ground-truth error signal.

Port of ``vil_sensor_fusion_tpu/eval/correlations.py``: the metric series
come from ``degeneracy.score_series`` on the matrices' device, the
transforms (identity / log / difference) are taken there too, and the
Pearson correlation runs in numpy float64 on the host.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..degeneracy import gate as DG


class CorrelationResult(NamedTuple):
    metric: str
    block: str          # all / trans / rot
    transform: str      # raw / log / diff / log_diff
    error_signal: str
    pearson_r: float
    source: str = "mats"  # matrix source (hessian / pose_cov / twist_cov)


def _transforms(x: torch.Tensor) -> Mapping[str, torch.Tensor]:
    safe = torch.where(torch.abs(x) < 1e-30, 1e-30, torch.abs(x))
    logx = torch.log(safe)
    return {
        "raw": x,
        "log": logx,
        "diff": torch.cat([x[:1] * 0, torch.diff(x)]),
        "log_diff": torch.cat([logx[:1] * 0, torch.diff(logx)]),
    }


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m = np.isfinite(a) & np.isfinite(b)
    if m.sum() < 3:
        return np.nan
    a, b = a[m] - a[m].mean(), b[m] - b[m].mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else np.nan


def search(
    metric_names: Sequence[str],
    mats: torch.Tensor,                       # (T, 6, 6) cov/Hessian series
    error_signals: Mapping[str, np.ndarray],  # name -> (T,)
    poses: torch.Tensor | None = None,
    top_k: int = 20,
    source: str = "mats",
) -> list[CorrelationResult]:
    """The |r|-strongest (metric, block, transform, error) combinations for
    ONE matrix source; :func:`search_sources` sweeps several."""
    scores = DG.score_series(metric_names, mats, poses)
    out = []
    for name, sc in scores.items():
        for block, series in (("all", sc.score_all),
                              ("trans", sc.score_trans),
                              ("rot", sc.score_rot)):
            for tname, ts in _transforms(series).items():
                ts_np = ts.detach().cpu().numpy()
                for ename, err in error_signals.items():
                    r = _pearson(ts_np, err)
                    if np.isfinite(r):
                        out.append(CorrelationResult(
                            metric=name, block=block, transform=tname,
                            error_signal=ename, pearson_r=r,
                            source=source))
    out.sort(key=lambda c: -abs(c.pearson_r))
    return out[:top_k]


def search_sources(
    metric_names: Sequence[str],
    sources: Mapping[str, torch.Tensor],      # name -> (T, 6, 6) series
    error_signals: Mapping[str, np.ndarray],
    poses: torch.Tensor | None = None,
    top_k: int = 20,
) -> list[CorrelationResult]:
    """Every (matrix source × metric × sub-block × transform) against every
    error signal (find_correlations.py:94-138), one source at a time."""
    out = []
    for sname, mats in sources.items():
        out.extend(search(metric_names, mats, error_signals, poses=poses,
                          top_k=len(metric_names) * 12 * len(error_signals),
                          source=sname))
    out.sort(key=lambda c: -abs(c.pearson_r))
    return out[:top_k]

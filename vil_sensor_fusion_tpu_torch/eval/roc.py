"""Degeneracy-detector quality: ROC / AUC over labeled degenerate time
windows — the offline analysis of vil_fusion/python/make_prettier_graphs.py
(calc_roc at :579-588, labeled windows DEGEN_ROT / DEGEN_TRANS at :46-120).

Port of ``vil_sensor_fusion_tpu/eval/roc.py``. The thresholds are score
quantiles taken as ``jnp.quantile`` takes them (:func:`_quantile`), and
the AUC is ``torch.trapezoid`` over the (fpr, tpr) curve.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .._linspace import linspace0


class RocCurve(NamedTuple):
    thresholds: torch.Tensor  # (K,)
    tpr: torch.Tensor         # (K,)
    fpr: torch.Tensor         # (K,)
    auc: torch.Tensor         # scalar


def label_windows(
    times: torch.Tensor,
    windows: Sequence[tuple],
    kind: str | None = None,
) -> torch.Tensor:
    """Boolean degenerate-label series from labeled second windows.

    Windows are ``(start, end)`` or ``(start, end, kind)`` with kind in
    {"trans", "rot", "both"}; bare 2-tuples count as "trans". ``kind``
    labels only that degeneracy type (windows tagged "both" match either);
    ``kind=None`` labels every window."""
    lab = torch.zeros(times.shape, dtype=torch.bool, device=times.device)
    for w in windows:
        a, b = float(w[0]), float(w[1])
        k = w[2] if len(w) > 2 else "trans"
        if kind is not None and k != kind and k != "both":
            continue
        lab = lab | ((times >= a) & (times <= b))
    return lab


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c with one rounding, in float64: XLA contracts the quantile's
    interpolation into a fused multiply-add, and at tied scores the last
    bit decides ``score <= threshold``. The product's error comes from
    Dekker's split and the sum's from Knuth's two-sum; non-finite terms
    take IEEE's plain a·b + c, which is the fused result there too."""
    p = a * b
    split = 134217729.0                         # 2^27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    err_p = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    err_s = (p - (s - v)) + (c - v)
    fused = s + (err_s + err_p)
    return torch.where(torch.isfinite(p) & torch.isfinite(c), fused, p + c)


def _quantile(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (linear) of a 1-D ``a``: all NaN when ``a``
    holds a NaN, else ``a[hi]·w + a[lo]·(1 − w)`` at position q·(n − 1), in
    ``q``'s dtype, fused as XLA fuses it. ``torch.quantile`` interpolates as
    ``lerp``, which gives NaN at an exact position on ±inf where this gives
    ±inf, and rounds tied scores differently."""
    a = torch.where(torch.isnan(a).any(), torch.nan, a)
    a = torch.sort(a).values.to(q.dtype)
    n = a.shape[0]
    pos = q * (n - 1)
    lo = torch.floor(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    lo_i = torch.clamp(lo, 0, n - 1).long()
    hi_i = torch.clamp(torch.ceil(pos), 0, n - 1).long()
    return _fma(a[hi_i], w_hi, a[lo_i] * w_lo)


def roc(
    is_degen: torch.Tensor,
    score: torch.Tensor,
    num_thresholds: int = 100,
    low_is_degenerate: bool = True,
) -> RocCurve:
    """ROC with score-quantile thresholds, matching calc_roc: the detector
    flags 'degenerate' when ``score <= threshold`` (pass
    ``low_is_degenerate=False`` to flip the polarity).

    Args:
      is_degen: (T,) boolean ground-truth labels.
      score: (T,) metric values.
    """
    if not low_is_degenerate:
        score = -score
    qs = linspace0(1.0, num_thresholds, device=score.device)
    thresholds = _quantile(score, qs).to(score.dtype)
    est = score[None, :] <= thresholds[:, None]          # (K, T)
    pos = is_degen[None, :]
    tp = torch.sum(est & pos, dim=1)
    fp = torch.sum(est & ~pos, dim=1)
    n_pos = torch.clamp(torch.sum(is_degen), min=1)
    n_neg = torch.clamp(torch.sum(~is_degen), min=1)
    tpr = tp.double() / n_pos
    fpr = fp.double() / n_neg
    # fpr is nondecreasing over quantile thresholds, so the trapezoid over
    # (fpr, tpr) is the AUC.
    auc = torch.trapezoid(tpr, fpr)
    return RocCurve(thresholds=thresholds, tpr=tpr, fpr=fpr, auc=auc)


def auc_table(
    scores: dict,
    labels: torch.Tensor,
    num_thresholds: int = 100,
) -> dict:
    """AUC per metric name; ``scores`` maps name -> (T,) series."""
    return {name: float(roc(labels, s, num_thresholds).auc)
            for name, s in scores.items()}

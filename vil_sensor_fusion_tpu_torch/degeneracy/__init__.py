"""Degeneracy detection: metric library + gating (the thesis's
contribution)."""

from . import gate
from . import metrics
from .gate import (
    DegeneracyScores,
    GateConfig,
    GateResult,
    calibrate_threshold,
    logdet_gate,
    score_series,
)
from .metrics import METRICS

__all__ = [
    "gate",
    "metrics",
    "DegeneracyScores",
    "GateConfig",
    "GateResult",
    "calibrate_threshold",
    "logdet_gate",
    "score_series",
    "METRICS",
]

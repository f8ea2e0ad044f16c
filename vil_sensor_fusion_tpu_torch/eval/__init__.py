"""Evaluation: online diagnostics (DiagnosticMessage parity), offline
ATE/RPE and ROC/AUC analysis, and the experiment harness."""

from . import correlations
from . import diagnostics
from . import experiments
from . import plots
from . import roc
from .correlations import CorrelationResult
from .correlations import search as correlation_search
from .correlations import search_sources as correlation_search_sources
from .diagnostics import DiagnosticSeries, anchor_first_pose, ate_rmse
from .diagnostics import diagnostics as diagnostic_series
from .diagnostics import rpe, umeyama_alignment
from .roc import RocCurve, auc_table, label_windows
from .roc import roc as roc_curve

__all__ = [
    "correlations",
    "diagnostics",
    "experiments",
    "plots",
    "roc",
    "CorrelationResult",
    "correlation_search", "correlation_search_sources",
    "DiagnosticSeries",
    "anchor_first_pose", "ate_rmse", "umeyama_alignment",
    "diagnostic_series",
    "rpe",
    "RocCurve",
    "auc_table",
    "label_windows",
    "roc_curve",
]

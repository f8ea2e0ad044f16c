"""Failure detection: the estimator health verdict and guarded update."""

from . import health
from .health import (HealthLimits, all_finite, check_state,
                     finite_fraction, guarded_update, wrap_step)

__all__ = ["health", "HealthLimits", "all_finite", "check_state",
           "finite_fraction", "guarded_update", "wrap_step"]

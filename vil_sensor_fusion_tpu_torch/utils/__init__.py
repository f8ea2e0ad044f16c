"""Auxiliary subsystems: checkpoint / resume, tracing / profiling, failure
detection and elastic recovery."""

from . import checkpoint, health, tracing
from .checkpoint import CheckpointManager, restore, save
from .health import (HealthLimits, all_finite, check_state,
                     finite_fraction, guarded_update, wrap_step)
from .tracing import StageTimer, count, device_trace, recording, span

__all__ = ["checkpoint", "health", "tracing", "CheckpointManager",
           "restore", "save", "HealthLimits", "all_finite", "check_state",
           "finite_fraction", "guarded_update", "wrap_step", "StageTimer",
           "count", "device_trace", "recording", "span"]

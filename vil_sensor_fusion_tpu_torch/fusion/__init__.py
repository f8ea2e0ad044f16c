"""Fusion engine (sensor registry + synchronous measurement timeline) and
the LiDAR → gate → fusion pipeline."""

from . import engine
from . import vil
from .engine import (
    EngineState,
    FusedOutput,
    FusionConfig,
    SensorSpec,
    Timeline,
    init,
    merge_timeline,
    run,
    run_lanes,
    step,
)

__all__ = [
    "engine", "vil", "EngineState", "FusedOutput", "FusionConfig",
    "SensorSpec", "Timeline", "init", "merge_timeline", "run", "run_lanes",
    "step",
]

"""Fixed-lag factor-graph smoother (GTSAM/iSAM2 replacement)."""

from . import factors
from . import smoother
from .factors import KeyframeStates, STATE_DIM
from .smoother import (
    SmootherConfig,
    SmootherState,
    add_between,
    add_keyframe,
    add_unary,
    cost,
    init,
    latest,
    solve,
)

__all__ = [
    "factors", "smoother", "KeyframeStates", "STATE_DIM", "SmootherConfig",
    "SmootherState", "add_between", "add_keyframe", "add_unary", "cost", "init",
    "latest", "solve",
]

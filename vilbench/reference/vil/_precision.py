"""The matmul precision of the reference.

The port turns TF32 off and checks it before its estimator runs. The
reference leaves both switches as its caller set them: the benchmark runs
it with TF32 off, and its control (a driver's ``control`` side) with TF32
on, the nearest precision below full float32.
"""

from __future__ import annotations


def require_full_f32() -> None:
    """Kept for the call sites of the frozen engine; sets nothing."""

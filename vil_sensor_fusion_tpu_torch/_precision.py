"""Full-f32 matmul policy for the estimator.

The JAX package pins HIGHEST matmul precision around the estimation algebra
(``vil_sensor_fusion_tpu/_precision.py``). On an NVIDIA card the matching
hazard is TF32: with ``allow_tf32`` a float32 matmul or convolution keeps
about 10 mantissa bits. That breaks the normal-equation assembly (factor
information spans ~8 orders of magnitude) and the KNN distance rows
‖q‖² − 2q·t + ‖t‖², which cancel at map coordinates and lose sub-metre
neighbour ranking under TF32 (``frontends/lidar/icp.py:knn``).

:func:`require_full_f32` sets both TF32 switches off and checks that they
stayed off. The estimator's entry points call it before any work runs.
"""

from __future__ import annotations

import torch


def require_full_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN, then assert it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled; the estimator needs "
                           "full-f32 matmuls")

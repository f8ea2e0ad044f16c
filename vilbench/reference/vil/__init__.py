"""A frozen copy of the estimator of ``vil_sensor_fusion_tpu_torch``.

Copied from the port at commit 9df89905ef8a8933d2d3095c028767cc15a794cf
(``core/``, ``data/`` raycast / scenarios / synthetic, ``degeneracy/`` gate
and metrics, ``frontends/lidar/``, ``frontends/vio/`` without the
photometric mode, ``fusion/engine.py``, ``graph/`` factors and smoother,
``ops/`` eig3 / eig6 / knn, ``utils/health.py``, ``_linspace``,
``_scatter``, ``_tree``). What was changed:

- imports: relative as before, so nothing here reaches the port; the
  modules off the benchmark's path were left out (the bag writer of
  ``data/scenarios.py``, ``fusion/vil.py``, the photometric VIO,
  checkpointing and tracing) and the package ``__init__`` files trimmed to
  match;
- the k-NN is the plain ``knn_torch`` on every device (``ops/knn.py``); the
  CUDA kernel, its build and its custom op are gone;
- ``_precision.require_full_f32`` sets nothing: the caller chooses TF32 off
  (the reference) or on (the control).

Everything else is the port's code as it stood, so the reference computes
the same algorithm with another k-NN and another summation order.
"""

import torch

DEFAULT_DEVICE = torch.device("cuda")

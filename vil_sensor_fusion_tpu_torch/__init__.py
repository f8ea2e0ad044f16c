"""vil_sensor_fusion_tpu_torch — the PyTorch / CUDA port of
``vil_sensor_fusion_tpu`` for NVIDIA Hopper cards.

It mirrors the JAX package module for module (``core/lie.py``,
``frontends/lidar/icp.py``, ...) with the same public names, and is tested
against it on identical inputs. It imports ``torch`` and numpy, never
``jax``. The ported slice is the estimator's main path: VIO front-end →
LiDAR odometry → degeneracy gate → fusion back-end
(``fusion.vil.run_vil``). The one TPU kernel on that path, the exact 5-NN
of ``ops/knn.py``, is a hand-written CUDA kernel (``csrc/knn.cu``).

Entry points that create tensors put them on :data:`DEFAULT_DEVICE`, the
card, unless the caller passes ``device="cpu"`` (or CPU tensors).
"""

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = torch.device("cuda")

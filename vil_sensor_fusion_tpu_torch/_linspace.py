"""``jnp.linspace(0, stop, num)`` with JAX's values.

``torch.linspace`` and ``numpy.linspace`` round some interior points
differently from ``jnp.linspace`` (by an ulp), and the port needs JAX's
values where a grid feeds a comparison: the ROC's score quantiles (an
interpolation weight of exactly 0 or not) and the perturbation shifts.
``jnp.linspace`` forms ``start·(1 − i/div) + stop·(i/div)`` for ``i < div``
and appends ``stop``; with ``start = 0`` XLA folds that to
``(stop·(1/div))·i``, which this computes in float64 before one cast.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE
from ._consts import const


def _values(stop: float, num: int) -> np.ndarray:
    if num == 1:
        return np.zeros(1)
    div = num - 1
    return np.append((stop * (1.0 / div)) * np.arange(div, dtype=np.float64),
                     stop)


def linspace0(stop: float, num: int, dtype=torch.float64,
              device=DEFAULT_DEVICE) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` (endpoint included) in float64,
    cast to ``dtype`` on ``device``."""
    return torch.as_tensor(_values(stop, num), dtype=dtype, device=device)


def linspace0_const(stop: float, num: int, dtype, device) -> torch.Tensor:
    """:func:`linspace0`'s values as a shared device constant
    (``_consts.const``): what a step that a CUDA graph captures reads.
    Nothing may write into it."""
    return const(tuple(_values(stop, num).tolist()), dtype, device)

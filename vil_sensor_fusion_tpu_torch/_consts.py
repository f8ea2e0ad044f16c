"""Device constants made once per (values, dtype, device) and then shared.

A step that a CUDA graph captures may not copy host data to the device,
and the graph reads each constant at its address for as long as the graph
lives. So a constant is made the first time an eager call asks for it, the
cache never drops it (a few small tensors per configuration), and nothing
writes into its tensors.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def const(values: tuple, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once."""
    return torch.tensor(values, dtype=dtype, device=device)

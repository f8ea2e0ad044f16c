"""XLA's order for scatters with duplicate indices.

XLA applies a scatter's updates in index order, so where several updates
share a target the one with the highest index stays; a CUDA ``index_put_``
with duplicate indices keeps any of them. The port's functions whose JAX
counterparts rely on that order (``voxelmap.insert_hashed``,
``rangeimage.organize``) find the surviving update explicitly.
"""

from __future__ import annotations

import torch


def last_writer(n_targets: int, target: torch.Tensor) -> torch.Tensor:
    """(n_targets,) the highest update index that ``target`` (one target
    per update) sends to each target, −1 where none."""
    order = torch.arange(target.shape[0], device=target.device)
    last = torch.full((n_targets,), -1, dtype=torch.int64,
                      device=target.device)
    return last.scatter_reduce(0, target, order, reduce="amax")

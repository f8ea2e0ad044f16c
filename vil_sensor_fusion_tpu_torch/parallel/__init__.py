"""Parallelism over a (data, model) mesh of ``torch.distributed`` ranks:
data sharding over sequences (the lane-batched fusion engine on each data
rank), model sharding of the registration reductions (all-reduced normal
equations), and window sharding of a long pose chain."""

from . import mesh
from . import multihost
from . import ops
from .mesh import DATA_AXIS, MODEL_AXIS, data_sharding, make_mesh, replicated, shard_batch
from .ops import (
    batched_fusion_run,
    make_sharded_lidar_step,
    make_sharded_register,
    sharded_metric_series,
    sharded_normal_eqs,
)

__all__ = [
    "mesh", "multihost", "ops", "DATA_AXIS", "MODEL_AXIS", "data_sharding", "make_mesh",
    "replicated", "shard_batch", "batched_fusion_run",
    "make_sharded_lidar_step", "make_sharded_register",
    "sharded_metric_series", "sharded_normal_eqs",
]

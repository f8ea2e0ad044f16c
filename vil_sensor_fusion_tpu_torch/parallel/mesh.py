"""A (data, model) grid of ranks on ``torch.distributed``.

Port of ``vil_sensor_fusion_tpu/parallel/mesh.py``. Where JAX lays a
``Mesh`` of devices out and ``shard_map`` runs one program over it, here
every rank of a ``torch.distributed`` world runs the same program on its
own device, and a :class:`Mesh` holds what that program needs to know:

- axis ``"data"`` — independent sequences: each data rank runs its
  contiguous share of a batch;
- axis ``"model"`` — one estimator's registration point sets, sharded
  over ranks, their normal equations all-reduced over the model group.

Rank ``r`` sits at (data ``r // n_model``, model ``r % n_model``). Each axis
has one process group per line of the grid, and every collective of the
parallel modules goes through the group of its axis, at size 1 too.

With no launcher (no process group yet) :func:`make_mesh` starts a world
of one process on the caller's device: ``gloo`` for the CPU, ``nccl`` for
a card. Under a launcher (``torchrun``, or :func:`multihost.initialize`)
it uses the world that exists.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .. import DEFAULT_DEVICE, _tree

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh(NamedTuple):
    """This rank's view of the grid: ``shape[axis]`` the axis sizes,
    ``coords[axis]`` this rank's index on each axis (``None`` for a rank
    outside the grid), ``groups[axis]`` the process group of this rank's
    line along each axis, and ``device`` the device it computes on."""

    shape: dict
    coords: dict | None
    groups: dict | None
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _local_device(device) -> torch.device:
    """A card with no index means this process's card (``LOCAL_RANK``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def _ensure_world(device) -> None:
    """Start a world of one process on ``device`` if no process group
    exists yet (an in-process store: no port, no file)."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Build the (data, model) grid over the ranks of the world.

    ``devices``: the device this rank computes on, or a sequence of
    devices indexed by the rank's local rank; default the card. ``n_data``
    defaults to ``world_size // n_model``. Ranks past ``n_data · n_model``
    take part in building the groups (every rank must) and get no
    coordinates. Raises if the grid needs more ranks than the world has.
    Every rank of the world must call this with the same arguments."""
    if devices is None:
        devices = DEFAULT_DEVICE
    if isinstance(devices, (list, tuple)):
        devices = devices[int(os.environ.get("LOCAL_RANK", 0))
                          % len(devices)]
    device = _local_device(devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)    # NCCL's communicator device
    _ensure_world(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(
            f"a {n_data} x {n_model} (data x model) mesh needs "
            f"{n_data * n_model} ranks; this world has {world}: start one "
            f"process per rank, e.g. torchrun --nproc-per-node "
            f"{n_data * n_model}")
    groups: dict[str, Any] = {}
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[MODEL_AXIS] = g
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[DATA_AXIS] = g
    shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    if rank >= n_data * n_model:
        return Mesh(shape, None, None, device)
    coords = {DATA_AXIS: rank // n_model, MODEL_AXIS: rank % n_model}
    return Mesh(shape, coords, groups, device)


class Sharding(NamedTuple):
    """Where a tensor's leading axis lives: split in contiguous shares over
    ``axis`` (``None``: replicated on every rank)."""

    mesh: Mesh
    axis: str | None

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global tensor, on the mesh's device."""
        x = x.to(self.mesh.device)
        if self.axis is None:
            return x
        n, i = self.mesh.size(self.axis), self.mesh.index(self.axis)
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not tile the "
                             f"{self.axis} axis of size {n}")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]


def data_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) axis over the data axis."""
    return Sharding(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous share of every leaf's leading axis (the data
    axis), on the mesh's device."""
    sh = data_sharding(mesh)
    return _tree.tree_map(
        lambda x: sh.local(x) if isinstance(x, torch.Tensor) else x, tree)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of equal shape, concatenated in rank order along
    ``dim``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_batch(mesh: Mesh, tree):
    """The inverse of :func:`shard_batch`: every leaf's shares, gathered
    over the data group into the whole batch on every rank."""
    g = mesh.group(DATA_AXIS)
    return _tree.tree_map(
        lambda x: all_gather_cat(x, g) if isinstance(x, torch.Tensor) else x,
        tree)

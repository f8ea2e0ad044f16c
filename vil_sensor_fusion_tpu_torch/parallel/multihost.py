"""Multi-process execution: one program on every rank of a
``torch.distributed`` world, across processes and hosts.

Port of ``vil_sensor_fusion_tpu/parallel/multihost.py``. Where JAX joins a
cluster with ``jax.distributed.initialize`` and sees one global device
list, here every process calls :func:`initialize` (a ``tcp://`` rendezvous
at the coordinator's address), computes on its own device, and reaches
the others through collectives: ``nccl`` between cards, ``gloo`` between
CPU processes. ``torchrun`` does the same from its environment
(``init_process_group("nccl")`` with ``env://``); :func:`initialize` is for
callers that start the processes themselves.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .. import DEFAULT_DEVICE, _tree
from .mesh import (DATA_AXIS, Mesh, backend_for, gather_batch, make_mesh,
                   shard_batch)
from .step import local_fusion_ate


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=DEFAULT_DEVICE) -> None:
    """Join the world (idempotent per process). Every process calls this
    with the same ``coordinator_address`` (``host:port`` of process 0) and
    ``num_processes`` and its own ``process_id``; the backend fits
    ``device`` (``nccl`` for a card, ``gloo`` for the CPU)."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_data_mesh(device=DEFAULT_DEVICE) -> Mesh:
    """One data-parallel mesh over every rank of every host."""
    return make_mesh(n_model=1, devices=device)


def host_sharded(mesh: Mesh, tree):
    """Global batches from per-process local ones: each process passes its
    OWN shard (leading axis = local batch) and every process gets the
    concatenation over the data axis in rank order (the global batch)."""
    tree = _tree.tree_map(
        lambda x: torch.as_tensor(np.asarray(x), device=mesh.device)
        if not isinstance(x, torch.Tensor) else x.to(mesh.device), tree)
    return gather_batch(mesh, tree)


def _tiny_problem(dtype, n_events: int = 12, n_imu: int = 128,
                  batch: int | None = None, device=DEFAULT_DEVICE):
    """Deterministic small fusion problem (circle drive, 2 sensors) — the
    port's copy of ``__graft_entry__._tiny_problem``. Returns (cfg, (es,
    tl, imu_t, imu_a, imu_g)), each leaf with a leading ``batch`` axis
    when given."""
    from .. import convert
    from .. import fusion as fu
    from .. import graph as G
    from ..data import synthetic as syn

    traj = syn.circle(radius=10.0, period=10.0)
    imu_t = torch.arange(n_imu, dtype=dtype, device=device) / 100.0
    imu = syn.sample_imu(traj, imu_t)
    n_vio = n_events * 2 // 3
    n_lid = n_events - n_vio
    t_vio = (torch.arange(n_vio, dtype=dtype, device=device) + 1.0) / 20.0
    t_lid = (torch.arange(n_lid, dtype=dtype, device=device) + 1.0) / 10.0
    vio = syn.sample_odometry(traj, t_vio)
    lid = syn.sample_odometry(traj, t_lid)
    host = lambda x: x.cpu().numpy()
    tl = convert.to_torch(fu.merge_timeline([
        (host(t_vio), host(vio.poses), host(vio.cov), np.ones(n_vio)),
        (host(t_lid), host(lid.poses), host(lid.cov), np.ones(n_lid)),
    ]), device, dtype)
    cfg = fu.FusionConfig(
        smoother=G.SmootherConfig(window=4, between_slots=8, gn_iters=3),
        sensors=(fu.SensorSpec(name="vio", optimize_after_odom=True),
                 fu.SensorSpec(name="lidar", optimize_after_odom=False)),
        max_imu_per_gap=16,
    )
    t0 = torch.zeros((), dtype=dtype, device=device)
    es = fu.init(cfg, traj.pose_fn(t0), traj.vel_fn(t0),
                 torch.zeros(6, dtype=dtype, device=device), t0)
    args = (es, tl, imu.times, imu.accel, imu.gyro)
    if batch is None:
        return cfg, args
    return cfg, _tree.tree_map(
        lambda x: x.expand((batch,) + x.shape).clone(), args)


def fusion_scaling_workload(batch_per_device: int = 1, n_events: int = 48,
                            n_imu: int = 512, reps: int = 5,
                            device=DEFAULT_DEVICE):
    """The scaling benchmark: the lane-batched fusion engine data-parallel
    over every rank, with a global ATE all-reduced over the data group (a
    real cross-process collective each pass). Returns (events_per_s,
    global_events) on every rank; throughput is measured after a warm-up
    pass, the ranks held together by the collective itself.

    Weak scaling: each process contributes ``batch_per_device`` sequences,
    so two processes do twice the work."""
    mesh = global_data_mesh(device)
    dtype = torch.float32
    cfg, (es, tl, it, ia, ig) = _tiny_problem(
        dtype, n_events=n_events, n_imu=n_imu, batch=batch_per_device,
        device=mesh.device)
    E = tl.times.shape[1]
    gt = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype,
                      device=mesh.device).expand(batch_per_device, E, 7)
    # The global batch, then this rank's share of it: the path a caller
    # holding one host's data takes.
    args = shard_batch(mesh, host_sharded(mesh, (es, tl, it, ia, ig, gt)))

    _, _, ate = local_fusion_ate(mesh, cfg, *args)   # warm-up + barrier
    if not bool(torch.isfinite(ate)):
        raise FloatingPointError(f"non-finite global ATE {float(ate)}")
    t0 = time.perf_counter()
    for _ in range(reps):
        _, _, ate = local_fusion_ate(mesh, cfg, *args)
    float(ate)                                  # the last pass's sync
    dt = (time.perf_counter() - t0) / reps
    global_events = batch_per_device * mesh.size(DATA_AXIS) * E
    return global_events / dt, global_events

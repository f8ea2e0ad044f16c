"""Sharded execution of the estimator over a (data, model) mesh of ranks.

Port of ``vil_sensor_fusion_tpu/parallel/ops.py``. Two parallel axes:

- **data**: independent sequences. Each data rank runs the lane-batched
  fusion engine (``fusion.engine.run_lanes``: one set of ops per event for
  all its lanes) on its contiguous share of the batch.
- **model**: the registration point sets. Each model rank accumulates the
  point-to-line/plane normal equations of its shard of the query points,
  and (H, g, cost) are all-reduced over the model group every GN step.

Calling convention: every function takes the GLOBAL arrays on every rank,
as the JAX functions take global arrays, and returns what JAX returns:
a result sharded over an axis is all-gathered, so every rank holds the
whole of it (a (B, ...) batch, not its share). That costs one all-gather
per leaf at the end of a call and lets a caller on any rank read every
lane, as it reads a JAX global array.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import _tree
from ..degeneracy import gate
from ..frontends.lidar import icp as I
from ..frontends.lidar import odometry as O
from ..fusion import engine as E
from .mesh import MODEL_AXIS, gather_batch, shard_batch


def batched_fusion_run(mesh, cfg: E.FusionConfig):
    """The fusion engine on a batch of sequences, the batch split over the
    mesh's data axis.

    fn(states, timelines, imu_times, imu_accel, imu_gyro) →
      (final states, FusedOutput); every input's leading axis is the
      batch B (a multiple of the data-axis size), and so is every output's.
    """

    def fn(states, timelines, it, ia, ig):
        local = shard_batch(mesh, (states, timelines, it, ia, ig))
        return gather_batch(mesh, E.run_lanes(cfg, *local))

    return fn


def _model_shard(mesh, x: torch.Tensor) -> torch.Tensor:
    n, i = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    if x.shape[0] % n:
        raise ValueError(f"point axis {x.shape[0]} does not tile the model "
                         f"axis of size {n}")
    k = x.shape[0] // n
    return x.to(mesh.device)[i * k:(i + 1) * k]


def sharded_normal_eqs(mesh):
    """ICP normal equations over point shards: inputs (res (N, r),
    J (N, r, 6), w (N,)) with N split over the model axis; output the
    global (H (6, 6), g (6,)), all-reduced over the model group."""

    def fn(res, J, w):
        res, J, w = (_model_shard(mesh, x) for x in (res, J, w))
        H = torch.einsum("qri,q,qrj->ij", J, w, J)
        g = torch.einsum("qri,q,qr->i", J, w, res)
        Hg = torch.cat([H.reshape(-1), g])
        dist.all_reduce(Hg, group=mesh.group(MODEL_AXIS))
        return Hg[:36].reshape(6, 6), Hg[36:]

    return fn


def make_sharded_register(mesh, icp_cfg):
    """``icp.register`` with the query point sets sharded over the model
    axis and the map replicated: every GN step each rank fits and
    accumulates the normal equations of its point shard, then (H, g, cost)
    are all-reduced over the model group, so every rank applies the same
    global update (``icp.register``'s ``group``). Returns a function with
    ``register``'s positional signature (cfg aside), for
    ``odometry.step(register_fn=...)``."""
    n = mesh.size(MODEL_AXIS)

    def pad(x):
        # Pad the query axis to a multiple of the model-axis size; padded
        # rows carry mask 0 and contribute nothing.
        k = (-x.shape[0]) % n
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, k))

    def register_fn(pose0, qc, mc, qs, ms, map_c, map_cm, map_s, map_sm):
        qc, mc, qs, ms = (_model_shard(mesh, pad(x)) for x in (qc, mc, qs, ms))
        return I.register(pose0, qc, mc, qs, ms, map_c, map_cm, map_s,
                          map_sm, icp_cfg, group=mesh.group(MODEL_AXIS))

    return register_fn


def make_sharded_lidar_step(mesh, cfg):
    """The LiDAR odometry step (undistortion → features → scan-to-scan →
    submap → sharded scan-to-map registration → map update) with the
    scan-to-map normal equations model-parallel over the mesh; the rest is
    replicated on every rank.

    fn(state, sweep, pose_guess) → (state, LidarOdomResult)."""
    reg = make_sharded_register(mesh, cfg.icp)

    def stepfn(state, sweep, guess):
        return O.step(cfg, state, sweep, guess, register_fn=reg)

    return stepfn


def sharded_metric_series(mesh, names):
    """Degeneracy metric series over a (B, T, 6, 6) Hessian batch, B split
    over the data axis — the whole-fleet ``score_series``. Returns
    {name: DegeneracyScores} with (B, T) leaves on every rank. Each rank
    scores its lanes one by one (the metrics are not on the estimator's hot
    path)."""
    def fn(mats):
        local = shard_batch(mesh, mats)
        per_lane = [gate.score_series(names, m) for m in local]
        stacked = {k: _tree.tree_map(lambda *xs: torch.stack(xs),
                                     *(p[k] for p in per_lane))
                   for k in per_lane[0]}
        return gather_batch(mesh, stacked)

    return fn

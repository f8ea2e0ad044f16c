"""The multi-rank VIL step: everything the estimator does per round of
measurements, expressed once over the (data, model) mesh —

- data-parallel fusion: each data rank runs the lane-batched engine over
  its share of the sequences,
- model-parallel registration: the ICP residual blocks split over points,
  their normal equations all-reduced over the model group,
- a global ATE, its sums all-reduced over the data group.

Port of ``vil_sensor_fusion_tpu/parallel/step.py``; the calling convention
(global inputs and outputs on every rank) is ``ops``'.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import lie
from ..fusion import engine as E
from .mesh import DATA_AXIS, gather_batch, shard_batch
from .ops import sharded_normal_eqs


def local_fusion_ate(mesh, cfg: E.FusionConfig, states, timelines, imu_t,
                     imu_a, imu_g, gt_poses):
    """This rank's lanes through the lane-batched engine, and the global
    translation ATE over every data rank's lanes (its two sums
    all-reduced over the data group). Returns (states, fused, ATE) with
    this rank's lanes only."""
    es, out = E.run_lanes(cfg, states, timelines, imu_t, imu_a, imu_g)
    err = lie.pose_trans(out.poses) - lie.pose_trans(gt_poses)
    sums = torch.stack([torch.sum(err * err), torch.tensor(
        float(err.shape[0] * err.shape[1]), dtype=err.dtype,
        device=err.device)])
    dist.all_reduce(sums, group=mesh.group(DATA_AXIS))
    return es, out, torch.sqrt(sums[0] / sums[1])


def make_vil_step(mesh, cfg: E.FusionConfig):
    """Build the multi-rank step.

    fn(states, timelines, imu_t, imu_a, imu_g, gt_poses,
       icp_res, icp_J, icp_w) →
      (final states, fused outputs, global ATE, (H, g))

    Leading batch axes split over ``data``; the ICP point axis over
    ``model``.
    """
    normal_eqs = sharded_normal_eqs(mesh)

    def step(states, timelines, imu_t, imu_a, imu_g, gt_poses, icp_res,
             icp_J, icp_w):
        es, out, ate = local_fusion_ate(mesh, cfg, *shard_batch(
            mesh, (states, timelines, imu_t, imu_a, imu_g, gt_poses)))
        es, out = gather_batch(mesh, (es, out))
        return es, out, ate, normal_eqs(icp_res, icp_J, icp_w)

    return step

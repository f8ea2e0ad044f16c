"""Aten ops per step of every lane-batched stage against its single-lane
form, counted on the CPU with a ``TorchDispatchMode`` (every op that
reaches aten, views included). Any ``vmap`` batching-rule fallback is an
error. Run from the root of the repository:

    python3 tools/lane_ops.py

- Per fusion event: ``fusion.run`` (one lane) against ``fusion.run_lanes``
  at 1, 2 and 8 lanes, at the bench's fusion config (window 6, 12 between
  slots, 4 GN iterations, 32 IMU samples per gap, the VIO/LiDAR sensor
  pair) on the tiny circle-drive timeline.
- Per tracked frame, per VIO frame and per LiDAR sweep: the bench's
  stages (``bench.lanes_pass``: ``track_frames_lanes``,
  ``pipeline.run_lanes``, ``odometry.run_lanes``) at 1, 2 and 8 lanes
  against the single-sequence functions (``track_frames``,
  ``pipeline.run``, ``odometry.run``), at the bench's operating point on a
  small rig (160×120 camera, maps 4,096 / 8,192, submaps 512 / 1,024,
  town drives of 0.3 s: 6 frames, 3 sweeps). The counts do not depend on
  image or map sizes: every loop runs a fixed number of times.

A count of operations, not a time: on the card each op costs its launch
and the host's dispatch (~18 µs per op on an H100, PERF.md §6).
"""

from __future__ import annotations

import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from vil_sensor_fusion_tpu_torch import _tree  # noqa: E402
from vil_sensor_fusion_tpu_torch import bench as BN  # noqa: E402
from vil_sensor_fusion_tpu_torch import fusion as fu  # noqa: E402
from vil_sensor_fusion_tpu_torch import graph as G  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends import lidar as L  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends import vio as V  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.vio import frontend as F  # noqa: E402,E501
from vil_sensor_fusion_tpu_torch.fusion import vil  # noqa: E402
from vil_sensor_fusion_tpu_torch.parallel import multihost as MH  # noqa: E402

N_EVENTS = 6
LANES = (1, 2, 8)
SMALL_RIG = BN.Rig(cam_w=160, cam_h=120, corner_capacity=4096,
                   surf_capacity=8192, submap_corners=512, submap_surfs=1024)
STAGE_DURATION = 0.3


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops(fn, *args) -> int:
    with OpCount() as c:
        fn(*args)
    return c.n


def fusion_counts() -> dict:
    _, (_, tl, it, ia, ig) = MH._tiny_problem(
        torch.float32, n_events=N_EVENTS, n_imu=128, device="cpu")
    cfg = fu.FusionConfig(
        smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
        sensors=vil.VilConfig().fusion.sensors, max_imu_per_gap=32)
    es = fu.init(cfg, tl.odo_pose[0], torch.zeros(3), torch.zeros(6),
                 torch.zeros(()))
    one = (es, tl, it, ia, ig)
    out = {"events": N_EVENTS, "solving_events":
           int((tl.source == 0).sum()),
           "single_lane_run": ops(fu.run, cfg, *one) / N_EVENTS}
    for lanes in LANES:
        args = _tree.tree_map(lambda x: x.expand((lanes,) + x.shape).clone(),
                              one)
        out[f"run_lanes_B{lanes}"] = ops(fu.run_lanes, cfg, *args) / N_EVENTS
    return out


def stage_counts() -> dict:
    """Ops per tracked frame, VIO frame and LiDAR sweep of the bench's
    stages, single-sequence and at 1, 2 and 8 lanes (the first lanes of
    one set of 8 distinct town drives)."""
    cfg = BN.bench_config(SMALL_RIG)
    x = BN.build_inputs(cfg, max(LANES), STAGE_DURATION, torch.device("cpu"))
    s = BN.initial_states(cfg, x)
    fe, T_v, T_l = cfg.frontend, len(x.vio_times), len(x.lidar_times)
    pyrs = F.pyramids_batch(fe, x.images)
    cand = F.candidates_batch(fe, x.images, x.cam_points, x.cam_point_valid)
    frames = F.track_frames_lanes(fe, pyrs, *cand, x.imu_windows,
                                  cfg.vio.num_landmarks)
    _, vio = V.pipeline.run_lanes(cfg.vio, s.vio, frames)
    guesses = BN.delta_guesses(vio.pose, x.pose0, x.guess_idx)
    first = lambda tree, n: _tree.tree_map(lambda v: v[:n], tree)  # noqa
    lane0 = lambda tree: _tree.tree_map(lambda v: v[0], tree)  # noqa: E731
    out = {"rig": f"{SMALL_RIG.cam_w}x{SMALL_RIG.cam_h}, maps "
                  f"{SMALL_RIG.corner_capacity}/{SMALL_RIG.surf_capacity}",
           "frames": T_v, "sweeps": T_l}
    out["tracker_single"] = ops(
        F.track_frames, fe, lane0(pyrs), *lane0(cand),
        lane0(x.imu_windows), cfg.vio.num_landmarks) / T_v
    out["vio_single"] = ops(V.run, cfg.vio, lane0(s.vio),
                            lane0(frames)) / T_v
    out["lidar_single"] = ops(L.odometry.run, cfg.lidar, lane0(s.lidar),
                              lane0(x.sweeps), guesses[0]) / T_l
    for B in LANES:
        out[f"tracker_lanes_B{B}"] = ops(
            F.track_frames_lanes, fe, first(pyrs, B), *first(cand, B),
            first(x.imu_windows, B), cfg.vio.num_landmarks) / T_v
        out[f"vio_lanes_B{B}"] = ops(V.pipeline.run_lanes, cfg.vio,
                                     first(s.vio, B),
                                     first(frames, B)) / T_v
        out[f"lidar_lanes_B{B}"] = ops(L.odometry.run_lanes, cfg.lidar,
                                       first(s.lidar, B),
                                       first(x.sweeps, B),
                                       guesses[:B]) / T_l
    return out


def main() -> int:
    warnings.filterwarnings("error", message=".*performance drop.*")
    print(json.dumps({"fusion_per_event": fusion_counts(),
                      "stages": stage_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Aten ops per fusion event: the single-lane engine (``fusion.run``)
against the lane-batched one (``fusion.run_lanes``) at 1, 2 and 8 lanes,
counted on the CPU with a ``TorchDispatchMode`` (every op that reaches
aten, views included), at the bench's fusion config (window 6, 12 between
slots, 4 GN iterations, 32 IMU samples per gap, the VIO/LiDAR sensor pair)
on the tiny circle-drive timeline. Any ``vmap`` batching-rule fallback is
an error. Run from the root of the repository:

    python3 tools/lane_ops.py
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
from vil_sensor_fusion_tpu_torch import fusion as fu  # noqa: E402
from vil_sensor_fusion_tpu_torch import graph as G  # noqa: E402
from vil_sensor_fusion_tpu_torch.fusion import vil  # noqa: E402
from vil_sensor_fusion_tpu_torch.parallel import multihost as MH  # noqa: E402

N_EVENTS = 6


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    warnings.filterwarnings("error", message=".*performance drop.*")
    _, (_, tl, it, ia, ig) = MH._tiny_problem(
        torch.float32, n_events=N_EVENTS, n_imu=128, device="cpu")
    cfg = fu.FusionConfig(
        smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
        sensors=vil.VilConfig().fusion.sensors, max_imu_per_gap=32)
    es = fu.init(cfg, tl.odo_pose[0], torch.zeros(3), torch.zeros(6),
                 torch.zeros(()))
    one = (es, tl, it, ia, ig)
    with OpCount() as c:
        fu.run(cfg, *one)
    out = {"events": N_EVENTS, "solving_events":
           int((tl.source == 0).sum()), "single_lane_run": c.n / N_EVENTS}
    for lanes in (1, 2, 8):
        args = _tree.tree_map(lambda x: x.expand((lanes,) + x.shape).clone(),
                              one)
        with OpCount() as c:
            fu.run_lanes(cfg, *args)
        out[f"run_lanes_B{lanes}"] = c.n / N_EVENTS
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

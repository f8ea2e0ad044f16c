"""Aten ops of the port's user-script modules, counted on the CPU with a
``TorchDispatchMode`` (every op that reaches aten, views included), and
their k-NN calls. Run from the root of the repository:

    python3 tools/script_ops.py

- ``lidar_ablation``: per candidate schedule, ops and k-NN calls per
  sweep of ``odometry.run_lanes`` over 2 and 8 lanes (distorted town
  drives of 0.3 s, 3 sweeps, at the candidates' settings with maps 4,096 /
  8,192 and submaps 512 / 1,024: the counts do not depend on map sizes).
- ``profile_stages``: ops of one call of every row, sections ``frontend``
  and ``lidar`` at the script's defaults (400×300, 80 frames), ``fusion``
  at 16 frames and 8 sweeps (24 events).

A count of operations, not a time: on the card each op costs its launch
and the host's dispatch (8-18 µs per op on an H100 by stage, PERF.md §5).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vil_sensor_fusion_tpu_torch import _tree  # noqa: E402
from vil_sensor_fusion_tpu_torch import lidar_ablation as LA  # noqa: E402
from vil_sensor_fusion_tpu_torch import profile_stages as PS  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends import lidar as L  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as vm  # noqa: E402,E501
from vil_sensor_fusion_tpu_torch.ops import knn as K  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
from lane_ops import OpCount  # noqa: E402

CPU = torch.device("cpu")


@contextlib.contextmanager
def knn_count(box: list):
    knn = K.knn

    def counted(*a, **kw):
        box[0] += 1
        return knn(*a, **kw)
    K.knn = counted
    try:
        yield
    finally:
        K.knn = knn


def ablation_counts() -> dict:
    sweeps, gt = LA.build_lanes(0.3, 8, CPU)
    prior = LA.guesses(gt, CPU)
    T = prior.shape[1]
    out = {}
    for name, cfg in LA.CANDIDATES.items():
        cfg = cfg._replace(
            corner_map=vm.VoxelMapConfig(capacity=4096, leaf=0.2),
            surf_map=vm.VoxelMapConfig(capacity=8192, leaf=0.4),
            submap_corners=512, submap_surfs=1024)
        row = {}
        for B in (2, 8):
            pick = lambda tree: _tree.tree_map(lambda x: x[:B], tree)  # noqa
            st = LA.initial_states(cfg, torch.as_tensor(gt[:B, 0]))
            box = [0]
            with OpCount() as c, knn_count(box):
                L.odometry.run_lanes(cfg, st, pick(sweeps), prior[:B])
            row[f"ops_per_sweep_B{B}"] = c.n / T
            row["knn_calls_per_sweep"] = box[0] / T
        out[name] = row
    return out


def profile_counts() -> dict:
    counts = {}

    def count_row(name, fn, *args, reps=0):
        box = [0]
        with OpCount() as c, knn_count(box):
            fn(*args)
        counts[name] = {"ops": c.n, "knn_calls": box[0]}
        return counts[name]

    PS.bench, bench = count_row, PS.bench
    try:
        with contextlib.redirect_stdout(sys.stderr):
            PS.run(PS.parse_args(["--device", "cpu", "--only",
                                  "frontend,lidar"]))
            PS.run(PS.parse_args(["--device", "cpu", "--only", "fusion",
                                  "--frames", "16", "--sweeps", "8"]))
    finally:
        PS.bench = bench
    return counts


def main() -> int:
    warnings.filterwarnings("error", message=".*performance drop.*")
    torch.set_num_threads(min(8, torch.get_num_threads()))
    print(json.dumps({"lidar_ablation": ablation_counts(),
                      "profile_stages": profile_counts()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

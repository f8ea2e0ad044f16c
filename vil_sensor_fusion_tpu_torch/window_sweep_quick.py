"""Quick window sweep: the stream ATE against ground truth of the fixed-lag
fusion engine over window sizes, without the batch MAP. The port's
counterpart of the repository's ``scripts/window_sweep_quick.py``; the full
fixed-lag-against-batch report is :mod:`.oracle_report`, which solves the
batch MAP on top of this module's problem.

    python -m vil_sensor_fusion_tpu_torch.window_sweep_quick
        [--duration 15] [--noise 0.02] [--windows 4,6,10,16] [--gn-iters 5]
        [--device cuda]

The problem is a 10 m circle (200 Hz IMU, 20 Hz VIO and 10 Hz LiDAR
odometry with Gaussian position noise drawn by
``numpy.random.default_rng(seed)`` in the JAX script's order, so both
packages perturb identically). Everything runs in float64 on ``--device``.
One line per window, ``W=  4  ate_stream=0.01814 m``, as the JAX script
prints it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import convert
from . import fusion as fu
from . import graph as G
from .data import synthetic as syn
from .soak import require_device
from .utils.tracing import block_until_ready as ready

DTYPE = torch.float64
IMU_HZ = 200.0


def _fusion_cfg(window: int, gn_iters: int = 5) -> fu.FusionConfig:
    return fu.FusionConfig(
        smoother=G.SmootherConfig(window=window, between_slots=2 * window,
                                  gn_iters=gn_iters),
        sensors=(
            fu.SensorSpec(name="vio", optimize_after_odom=True,
                          covariance_linear=0.02, covariance_angular=0.02,
                          max_time_skip=0.2),
            fu.SensorSpec(name="lidar", optimize_after_odom=False,
                          covariance_linear=0.02, covariance_angular=0.02,
                          max_time_skip=0.3),
        ),
        max_imu_per_gap=32,
    )


def stream_problem(duration: float, noise: float, seed: int = 0,
                   device="cuda") -> dict:
    """Timeline, IMU stream, initial state and ground truth on ``device``.
    The stamps are numpy's float64 grids (what JAX's ``arange / hz``
    gives), moved to the device."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    traj = syn.circle(radius=10.0, period=20.0)

    def grid(n, hz, first=0.0):
        return torch.as_tensor((np.arange(n, dtype=np.float64) + first) / hz,
                               device=dev)

    imu = syn.sample_imu(traj, grid(int(duration * IMU_HZ) + 20, IMU_HZ))
    t_vio = grid(int(duration * 20.0), 20.0, 1.0)
    t_lid = grid(int(duration * 10.0), 10.0, 1.0)
    vio = syn.sample_odometry(traj, t_vio)
    lid = syn.sample_odometry(traj, t_lid)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    vp, lp = host(vio.poses).copy(), host(lid.poses).copy()
    vp[:, 4:7] += rng.normal(0, noise, vp[:, 4:7].shape)
    lp[:, 4:7] += rng.normal(0, noise, lp[:, 4:7].shape)
    tl = convert.to_torch(fu.merge_timeline([
        (host(t_vio), vp, host(vio.cov), np.ones(len(vp))),
        (host(t_lid), lp, host(lid.cov), np.ones(len(lp))),
    ]), dev, DTYPE)
    t0 = torch.zeros((), dtype=DTYPE, device=dev)
    gt = syn.sample_ground_truth(traj, tl.times)
    return dict(tl=tl, imu=imu, pose0=traj.pose_fn(t0),
                vel0=traj.vel_fn(t0),
                bias0=torch.zeros(6, dtype=DTYPE, device=dev),
                gt_tr=host(gt.poses)[:, 4:7])


def run_stream(prob: dict, window: int, gn_iters: int = 5) -> dict:
    """The fixed-lag engine with a ``window``-keyframe window over
    ``prob``'s timeline: its translations, their ATE against ground truth
    and the run's seconds (host clock, ending in a sync)."""
    cfg = _fusion_cfg(window, gn_iters)
    pose0 = prob["pose0"]
    es = fu.init(cfg, pose0, prob["vel0"], prob["bias0"],
                 torch.zeros((), dtype=DTYPE, device=pose0.device))
    imu = prob["imu"]
    ready(es)
    t_s = time.perf_counter()
    _, out = ready(fu.run(cfg, es, prob["tl"], imu.times, imu.accel,
                          imu.gyro))
    wall = time.perf_counter() - t_s
    stream_tr = out.poses[:, 4:7].cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum((stream_tr - prob["gt_tr"]) ** 2,
                                       axis=-1))))
    return {"stream_tr": stream_tr, "ate_stream_m": ate, "wall_s": wall}


def run_case(duration: float, noise: float, window: int, seed: int = 0,
             gn_iters: int = 5, device="cuda") -> float:
    """The stream ATE (m) of one window over a fresh problem."""
    return run_stream(stream_problem(duration, noise, seed, device), window,
                      gn_iters)["ate_stream_m"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m vil_sensor_fusion_tpu_torch.window_sweep_quick",
        description="Stream ATE of the fixed-lag engine per window.")
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--windows", default="4,6,10,16")
    ap.add_argument("--gn-iters", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = require_device(args.device, "the window sweep")
    ates = {}
    for w in map(int, args.windows.split(",")):
        ates[w] = run_case(args.duration, args.noise, w,
                           gn_iters=args.gn_iters, device=dev)
        print(f"W={w:3d}  ate_stream={ates[w]:.5f} m", flush=True)
    return {"duration_s": args.duration, "noise_m": args.noise,
            "gn_iters": args.gn_iters, "device": str(dev),
            "ate_stream_m": ates}


if __name__ == "__main__":
    main()

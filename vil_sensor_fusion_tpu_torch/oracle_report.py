"""Fixed-lag against full-history MAP: the streaming fixed-lag engine and
the offline float64 full-batch MAP (``graph/batch.py``) over the same event
timelines, and the trajectory gap between them. The port's counterpart of
the repository's ``scripts/oracle_report.py``.

    python -m vil_sensor_fusion_tpu_torch.oracle_report
        [--durations 15,30] [--noise 0.02] [--windows 4,6,10,16]
        [--device cuda] [--out PATH]

The problem is a 10 m circle (200 Hz IMU, 20 Hz VIO and 10 Hz LiDAR
odometry with Gaussian position noise drawn by
``numpy.random.default_rng(seed)`` in the JAX script's order, so both
packages perturb identically). The batch MAP does not depend on the window,
so it is solved once per duration and every window's fixed-lag run is
compared with it. Everything runs in float64 on ``--device``. Each case is
printed as a JSON line as it finishes; the whole report goes to ``--out``,
or to stdout without it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import convert
from . import fusion as fu
from . import graph as G
from .data import synthetic as syn
from .graph import batch as B
from .soak import card_line
from .utils.tracing import block_until_ready as ready

DTYPE = torch.float64
IMU_HZ = 200.0


def _fusion_cfg(window: int) -> fu.FusionConfig:
    return fu.FusionConfig(
        smoother=G.SmootherConfig(window=window, between_slots=2 * window,
                                  gn_iters=5),
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


def build_problem(duration: float, noise: float, seed: int = 0,
                  device="cuda") -> dict:
    """Timeline, IMU, ground truth and the (window-independent) batch MAP
    on ``device``. The stamps are numpy's float64 grids (what JAX's
    ``arange / hz`` gives), moved to the device."""
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
    pose0, vel0 = traj.pose_fn(t0), traj.vel_fn(t0)
    bias0 = torch.zeros(6, dtype=DTYPE, device=dev)

    cfg_any = _fusion_cfg(4)          # the batch ignores the window size
    ready((tl, imu, pose0, vel0))
    t_b = time.perf_counter()
    sol = ready(B.solve_batch(cfg_any, tl, imu.times, imu.accel, imu.gyro,
                              pose0, vel0, bias0, 0.0))
    t_batch = time.perf_counter() - t_b

    gt = syn.sample_ground_truth(traj, tl.times)
    gt_tr = host(gt.poses)[:, 4:7]
    batch_tr = host(sol.poses)[1:, 4:7]
    ate_batch = float(np.sqrt(np.mean(np.sum((batch_tr - gt_tr) ** 2,
                                             axis=-1))))
    return dict(tl=tl, imu=imu, pose0=pose0, vel0=vel0, bias0=bias0,
                batch=sol, batch_tr=batch_tr, gt_tr=gt_tr,
                ate_batch=ate_batch, n_between=sol.n_between,
                wall_batch=t_batch)


def run_window(prob: dict, duration: float, noise: float,
               window: int) -> dict:
    """The fixed-lag engine with a ``window``-keyframe window over
    ``prob``'s timeline, against its batch MAP and ground truth."""
    cfg = _fusion_cfg(window)
    pose0 = prob["pose0"]
    es = fu.init(cfg, pose0, prob["vel0"], prob["bias0"],
                 torch.zeros((), dtype=DTYPE, device=pose0.device))
    imu = prob["imu"]
    ready(es)
    t_s = time.perf_counter()
    _, out = ready(fu.run(cfg, es, prob["tl"], imu.times, imu.accel,
                          imu.gyro))
    t_stream = time.perf_counter() - t_s
    stream_tr = out.poses[:, 4:7].cpu().numpy()
    d_tr = np.linalg.norm(stream_tr - prob["batch_tr"], axis=-1)
    ate_stream = float(np.sqrt(np.mean(np.sum(
        (stream_tr - prob["gt_tr"]) ** 2, axis=-1))))
    return {
        "duration_s": duration, "noise_m": noise, "window": window,
        "events": int(prob["tl"].times.shape[0]),
        "n_between": prob["n_between"],
        "delta_mean_m": float(d_tr.mean()),
        "delta_max_m": float(d_tr.max()),
        "delta_last_m": float(d_tr[-1]),
        "ate_stream_m": ate_stream,
        "ate_batch_m": prob["ate_batch"],
        "wall_stream_s": round(t_stream, 2),
        "wall_batch_s": round(prob["wall_batch"], 2),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m vil_sensor_fusion_tpu_torch.oracle_report",
        description="Fixed-lag engine against the float64 full-batch MAP.")
    ap.add_argument("--durations", default="15,30")
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--windows", default="4,6,10,16")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="write the report here (default: stdout)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the oracle report runs on a CUDA card "
                               "(--device cuda); none is available")
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    cases = []
    for dur in map(float, args.durations.split(",")):
        prob = build_problem(dur, args.noise, device=dev)
        for w in map(int, args.windows.split(",")):
            c = run_window(prob, dur, args.noise, w)
            print(json.dumps(c), flush=True)
            cases.append(c)
    out = {
        "what": "streaming fixed-lag vs full-history f64 batch MAP, "
                "identical factor graphs (graph/batch.py); batch solved "
                "once per duration, windows swept with the FEJ "
                "marginal-prior policy (graph/smoother.py)",
        "device": str(dev),
        "cases": cases,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.out}", flush=True)
    else:
        print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()

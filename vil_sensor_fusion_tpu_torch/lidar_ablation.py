"""LiDAR-stage operating-point ablation: the bench's lane-batched LiDAR
stage (``--batch`` town drives as lanes, full VLP-16 sweeps with motion
distortion) timed under candidate iteration and refresh schedules, with
each schedule's registration error against ground truth, to pick the
fastest schedule that holds the error floor. The port's counterpart of
the repository's ``scripts/lidar_ablation.py``.

    python -m vil_sensor_fusion_tpu_torch.lidar_ablation [--duration 4]
        [--batch 8] [--reps 3] [--device cuda]

Per candidate: the lane states (``odometry.init`` at each drive's first
ground-truth pose), one first call of ``odometry.run_lanes`` (on a card
every k-NN search of a sweep is one kernel launch for all lanes), then
``--reps`` timed calls (host clock, ending in a sync). Rendering the drives
is untimed. The registration priors are the ground-truth relative motion
plus N(0, 0.01 m) on the translation, drawn from
``numpy.random.default_rng(0)`` in the JAX script's order. The table goes
to stderr, one line per candidate; the results go to stdout as one JSON
object under the JAX script's keys (``compile_s`` is ``first_call_s``
here: nothing is compiled), with the k-NN kernel's launches per sweep
(0 on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import _tree
from .core import lie
from .data import scenarios
from .frontends import lidar as L
from .ops import knn as K
from .soak import require_device
from .utils.tracing import block_until_ready as ready

DTYPE = torch.float32


def cfg_of(map_iters: int, odom_iters: int, fit_every: int, eig_sweeps: int,
           final_refresh: bool = False) -> L.LidarOdomConfig:
    return L.LidarOdomConfig(
        icp=L.IcpConfig(iters=map_iters, degen_eigval=5.0,
                        fit_every=fit_every, final_refresh=final_refresh,
                        eig_sweeps=eig_sweeps),
        odom_icp=L.IcpConfig(iters=odom_iters, max_corr_dist=2.0,
                             degen_eigval=5.0, fit_every=fit_every,
                             final_refresh=final_refresh,
                             eig_sweeps=eig_sweeps),
        two_stage=True, undistort=True, guess_is_delta=True)


CANDIDATES = {
    "r4_default (m4 o6 f2 e4)": cfg_of(4, 6, 2, 4),
    "m3 o4 f2 e4": cfg_of(3, 4, 2, 4),
    "m4 o6 f3 e4": cfg_of(4, 6, 3, 4),
    "m3 o4 f3 e3": cfg_of(3, 4, 3, 3),
    "m2 o4 f2 e3": cfg_of(2, 4, 2, 3),
    "m3 o3 f3 e3": cfg_of(3, 3, 3, 3),
}


def build_lanes(duration: float, batch: int, device) -> tuple:
    """``batch`` town drives (seed b for lane b) with motion-distorted
    sweeps, rendered on ``device``: sweeps (B, T, R, A, ·) and the
    ground-truth LiDAR poses (B, T, 7) as numpy."""
    scs = [scenarios.build("town", duration=duration, dtype=DTYPE,
                           device=device, seed=b, distort_sweeps=True)
           for b in range(batch)]
    sweeps = _tree.tree_map(lambda *xs: torch.stack(xs, 0),
                            *[sc.sweeps for sc in scs])
    return sweeps, np.stack([np.asarray(sc.gt_lidar_poses) for sc in scs])


def guesses(gt_b: np.ndarray, device, seed: int = 0) -> torch.Tensor:
    """Registration priors: each sweep's ground-truth motion since the
    previous one (the first: none), in float32, plus N(0, 0.01) m on the
    translation from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    prev = np.concatenate([gt_b[:, :1], gt_b[:, :-1]], axis=1)
    as_t = lambda x: torch.as_tensor(x, dtype=DTYPE, device=device)  # noqa
    g = lie.pose_between(as_t(prev), as_t(gt_b)).cpu().numpy()
    g[..., 4:7] += rng.normal(0, 0.01, g[..., 4:7].shape)
    return as_t(g)


def initial_states(cfg: L.LidarOdomConfig,
                   pose0: torch.Tensor) -> L.LidarOdomState:
    """Lane states from the (B, 7) initial poses."""
    return _tree.tree_map(lambda *xs: torch.stack(xs, 0), *[
        L.odometry.init(cfg, DTYPE, pose0=p) for p in pose0])


def run_candidate(cfg: L.LidarOdomConfig, sweeps, prior: torch.Tensor,
                  gt_b: np.ndarray, reps: int) -> tuple[dict, object]:
    """One candidate: a first call, then ``reps`` timed calls of
    ``odometry.run_lanes`` from the same lane states. Returns (its row,
    the last call's ``LidarOdomResult``)."""
    st0 = initial_states(cfg, torch.as_tensor(gt_b[:, 0], dtype=DTYPE,
                                              device=prior.device))
    n0 = K.KERNEL_LAUNCHES
    ready(st0)
    t0 = time.perf_counter()
    _, out = ready(L.odometry.run_lanes(cfg, st0, sweeps, prior))
    first_s = time.perf_counter() - t0
    launches = K.KERNEL_LAUNCHES - n0
    t0 = time.perf_counter()
    for _ in range(reps):
        _, out = L.odometry.run_lanes(cfg, st0, sweeps, prior)
    ready(out)
    wall = (time.perf_counter() - t0) / reps
    err = np.linalg.norm(out.pose[..., 4:7].cpu().numpy()
                         - gt_b[..., 4:7], axis=-1)
    return {
        "lidar_stage_ms": round(wall * 1e3, 1),
        "err_mean_m": round(float(err.mean()), 4),
        "err_max_m": round(float(err.max()), 4),
        "first_call_s": round(first_s, 1),
        "knn_launches_per_sweep": launches / prior.shape[1],
    }, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m vil_sensor_fusion_tpu_torch.lidar_ablation",
        description="LiDAR-stage schedules: time and registration error.")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = require_device(args.device, "the LiDAR ablation")
    print(f"platform={dev.type}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        K.build_kernel()
    sweeps, gt_b = build_lanes(args.duration, args.batch, dev)
    prior = guesses(gt_b, dev)

    results = {}
    for name, cfg in CANDIDATES.items():
        row, _ = run_candidate(cfg, sweeps, prior, gt_b, args.reps)
        results[name] = row
        print(f"{name:28s} {row['lidar_stage_ms']:7.1f} ms  err mean "
              f"{row['err_mean_m']:.4f} max {row['err_max_m']:.4f}  "
              f"(first call {row['first_call_s']:.1f}s)", file=sys.stderr,
              flush=True)
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()

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
import time

import numpy as np

from .graph import batch as B
from .soak import require_device
from .utils.tracing import block_until_ready as ready
from .window_sweep_quick import _fusion_cfg, run_stream, stream_problem


def build_problem(duration: float, noise: float, seed: int = 0,
                  device="cuda") -> dict:
    """:func:`window_sweep_quick.stream_problem` and, on top of it, the
    (window-independent) batch MAP on ``device``."""
    prob = stream_problem(duration, noise, seed, device)
    tl, imu = prob["tl"], prob["imu"]
    cfg_any = _fusion_cfg(4)          # the batch ignores the window size
    ready(prob)
    t_b = time.perf_counter()
    sol = ready(B.solve_batch(cfg_any, tl, imu.times, imu.accel, imu.gyro,
                              prob["pose0"], prob["vel0"], prob["bias0"],
                              0.0))
    t_batch = time.perf_counter() - t_b
    batch_tr = sol.poses[1:, 4:7].cpu().numpy()
    ate_batch = float(np.sqrt(np.mean(np.sum(
        (batch_tr - prob["gt_tr"]) ** 2, axis=-1))))
    return dict(prob, batch=sol, batch_tr=batch_tr, ate_batch=ate_batch,
                n_between=sol.n_between, wall_batch=t_batch)


def run_window(prob: dict, duration: float, noise: float,
               window: int) -> dict:
    """The fixed-lag engine with a ``window``-keyframe window over
    ``prob``'s timeline (:func:`window_sweep_quick.run_stream`), against
    its batch MAP and ground truth."""
    run = run_stream(prob, window)
    d_tr = np.linalg.norm(run["stream_tr"] - prob["batch_tr"], axis=-1)
    return {
        "duration_s": duration, "noise_m": noise, "window": window,
        "events": int(prob["tl"].times.shape[0]),
        "n_between": prob["n_between"],
        "delta_mean_m": float(d_tr.mean()),
        "delta_max_m": float(d_tr.max()),
        "delta_last_m": float(d_tr[-1]),
        "ate_stream_m": run["ate_stream_m"],
        "ate_batch_m": prob["ate_batch"],
        "wall_stream_s": round(run["wall_s"], 2),
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
    dev = require_device(args.device, "the oracle report")
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

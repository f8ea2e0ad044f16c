"""The f32 band behind the tolerances of ``chip_smoke.py``'s CPU reruns.

Default: phase 7's (``EXP_CROSS_TOL``, ``SCORE_TOL``). Runs the smoke
grid's corridor cell twice on the card, then its first ``CROSS_EXP_SWEEPS``
sweeps on the CPU in float32 and in float64 from the card's own scenario,
and prints ``compare_experiment`` for each pair: card against card (does
the device repeat itself), card and CPU f32 against the float64 run (each
device's f32 band), and card against CPU f32 (what the smoke's rerun holds
to its tolerances).

``--photometric``: phase 10's (``PHOTO_CROSS_TOL``). Records phase 8's bag,
replays it through ``run_vil_from_bag`` with ``vio.use_photometric: true``
on the card, then reruns the photometric VIO stage from the card's inputs:
on the card again, and on the CPU in float32 and float64, over the first
``PHOTO_CPU_FRAMES`` frames and over all frames; prints
``compare_photometric`` for the same pairs (with the first frame whose χ²
verdicts or live slots differ).

Needs a CUDA card; run from the root of the repository:

    python3 tools/cross_band.py [--photometric]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from vil_sensor_fusion_tpu_torch import _tree  # noqa: E402
from vil_sensor_fusion_tpu_torch.eval import experiments as EX  # noqa: E402


def _to64(v):
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.double()
    return v


def photometric_band(dev) -> None:
    (CS.REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CS.REPO / "build") as tmp:
        tmp = Path(tmp)
        bag = tmp / "town_full.bag"
        CS.record_bag(bag, dev)
        config = CS.photometric_config(tmp)
        sys_cfg = CS.C.load(str(config))
        rec = {}
        t0 = time.perf_counter()
        with CS.recorded_photometric(rec):
            _, res, _ = CS.VIL.run_vil_from_bag(
                bag, cfg=sys_cfg.vil(), fe_cfg=sys_cfg.frontend,
                topics=dict(gt_topic="/gt/odometry"), device=dev)
        print(f"card: {time.perf_counter() - t0:.1f} s", flush=True)
    T = res.vio_out.pose.shape[0]
    cpu = torch.device("cpu")
    for n in (CS.PHOTO_CPU_FRAMES, T):
        runs = {"card": (res.vio_out, rec)}
        for name, d, dt in (("card2", dev, torch.float32),
                            ("cpu32", cpu, torch.float32),
                            ("cpu64", cpu, torch.float64)):
            t0 = time.perf_counter()
            runs[name] = CS.rerun_photometric(rec, n, d, dt)
            print(f"{name}, {n} frames: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        for a, b in (("card", "card2"), ("card", "cpu64"),
                     ("cpu32", "cpu64"), ("card", "cpu32")):
            d = CS.compare_photometric(runs[a], runs[b], n)
            print(f"{a} vs {b}: " + json.dumps(d), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    CS._precision.require_full_f32()
    dev = torch.device("cuda", 0)
    print(f"card: {CS.gpu_line()}", flush=True)
    if "--photometric" in sys.argv[1:]:
        photometric_band(dev)
        return 0
    spec = EX.ExperimentSpec(kind="corridor",
                             duration=CS.EXPERIMENT_DURATION)
    cfg = EX.experiment_config(spec)
    sc = EX.experiment_scenario(spec, cfg, dev)
    n = CS.CROSS_EXP_SWEEPS
    head = CS.scenario_head(sc, n, torch.device("cpu"))
    head64 = head._replace(
        world=_tree.tree_map(_to64, head.world),
        imu_times=_to64(head.imu_times), imu_accel=_to64(head.imu_accel),
        imu_gyro=_to64(head.imu_gyro),
        vio_frames=_tree.tree_map(_to64, head.vio_frames),
        sweeps=_tree.tree_map(_to64, head.sweeps))
    runs = {}
    for name, scen in (("card", sc), ("card2", sc), ("cpu32", head),
                       ("cpu64", head64)):
        t0 = time.perf_counter()
        runs[name] = EX.run_scenario(spec, cfg, scen)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    for a, b in (("card", "card2"), ("card", "cpu64"), ("cpu32", "cpu64"),
                 ("card", "cpu32")):
        d = CS.compare_experiment(runs[a], runs[b], n)
        print(f"{a} vs {b}: " + json.dumps(d), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

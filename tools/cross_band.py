"""The f32 band behind the tolerances of ``chip_smoke.py``'s CPU reruns.

Default: phase 7's (``EXP_CROSS_TOL``, ``SCORE_TOL``). Builds the smoke
grid's corridor cell on the card and runs its first ``CROSS_EXP_SWEEPS``
sweeps twice on the card, then on the CPU in float32 and in float64 from
the card's own scenario, and prints ``compare_experiment`` for each pair:
card against card (does the device repeat itself), card and CPU f32
against the float64 run (each device's f32 band), and card against CPU
f32 (what the smoke's rerun holds to its tolerances). A run of a head
equals the head of a whole run: the estimator and the scores are causal.

``--kind``, ``--duration``, ``--sweeps``: another cell and head, e.g. the
field cell at 15 s through the end of its translation window (85 sweeps):

    python3 tools/cross_band.py --kind field --duration 15 --sweeps 85

Then it also prints, per head of 5, 10, 20, ... sweeps, each quantity's
gap of the card and of the CPU f32 to the float64 run, and the verdict of
the band: the card's gap no more than twice the CPU f32's in every
quantity and score series, and the same NaN / ±inf pattern in every score
on the card as on the CPU in float32 (the first head where either breaks
is named).

``--photometric``: phase 10's (``PHOTO_CROSS_TOL``). Records phase 8's bag,
replays it through ``run_vil_from_bag`` with ``vio.use_photometric: true``
on the card, then reruns the photometric VIO stage from the card's inputs:
on the card again, and on the CPU in float32 and float64, over the first
``PHOTO_CPU_FRAMES`` frames and over all frames; prints
``compare_photometric`` for the same pairs (with the first frame whose χ²
verdicts or live slots differ).

Needs a CUDA card; run from the root of the repository:

    python3 tools/cross_band.py [--photometric]
    python3 tools/cross_band.py [--kind KIND] [--duration S] [--sweeps N]
"""

from __future__ import annotations

import argparse
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


def gaps(d: dict) -> dict:
    """One ``compare_experiment`` result as a flat dict of gaps."""
    out = {k: v for k, v in d.items() if k not in (
        "score_class_mismatches", "score_rel_err")}
    out.update({f"score:{k}": v for k, v in d["score_rel_err"].items()})
    return out


def band_verdict(runs: dict, n: int) -> dict:
    """Per head of 5, 10, 20, ... ``n`` sweeps: the gaps of the card and of
    the CPU f32 to the float64 run, the quantities where the card's gap is
    more than twice the CPU's, and the score classes that differ between
    the card and the CPU f32. Prints one line per head."""
    heads = sorted({h for h in (5, *range(10, n, 10), n) if h <= n})
    first = {}
    for h in heads:
        card = gaps(CS.compare_experiment(runs["card"], runs["cpu64"], h))
        cpu = gaps(CS.compare_experiment(runs["cpu32"], runs["cpu64"], h))
        out = sorted(k for k in card if card[k] > 2 * cpu[k])
        masks = CS.compare_experiment(runs["card"], runs["cpu32"], h)[
            "score_class_mismatches"]
        for k in out:
            first.setdefault(k, h)
        if masks:
            first.setdefault("score classes", h)
        print(f"head {h}: card gap / CPU f32 gap to f64: " + json.dumps(
            {k: [card[k], cpu[k]] for k in card}) + f"; over 2x: {out}; "
            f"score classes differing card vs CPU f32: {masks}", flush=True)
    verdict = {"holds": not first, "first_head_out": first}
    print("band verdict: " + json.dumps(verdict), flush=True)
    return verdict


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--photometric", action="store_true")
    ap.add_argument("--kind", default="corridor")
    ap.add_argument("--duration", type=float, default=CS.EXPERIMENT_DURATION)
    ap.add_argument("--sweeps", type=int, default=CS.CROSS_EXP_SWEEPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    CS._precision.require_full_f32()
    dev = torch.device("cuda", 0)
    print(f"card: {CS.card_line()}", flush=True)
    if args.photometric:
        photometric_band(dev)
        return 0
    spec = EX.ExperimentSpec(kind=args.kind, duration=args.duration)
    cfg = EX.experiment_config(spec)
    sc = EX.experiment_scenario(spec, cfg, dev)
    n = args.sweeps
    head = CS.scenario_head(sc, n, torch.device("cpu"))
    head64 = head._replace(
        world=_tree.tree_map(_to64, head.world),
        imu_times=_to64(head.imu_times), imu_accel=_to64(head.imu_accel),
        imu_gyro=_to64(head.imu_gyro),
        vio_frames=_tree.tree_map(_to64, head.vio_frames),
        sweeps=_tree.tree_map(_to64, head.sweeps))
    card_head = CS.scenario_head(sc, n, dev)
    runs = {}
    for name, scen in (("card", card_head), ("card2", card_head),
                       ("cpu32", head), ("cpu64", head64)):
        t0 = time.perf_counter()
        runs[name] = EX.run_scenario(spec, cfg, scen)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    for a, b in (("card", "card2"), ("card", "cpu64"), ("cpu32", "cpu64"),
                 ("card", "cpu32")):
        d = CS.compare_experiment(runs[a], runs[b], n)
        print(f"{a} vs {b}: " + json.dumps(d), flush=True)
    lt = runs["cpu64"]["lidar_times"]
    print(f"{spec.kind} {spec.duration:g} s: {n} sweeps to t = "
          f"{float(lt[-1]):.2f} s, windows {runs['cpu64']['degen_windows']}"
          f", CPU f64 ATE LiDAR {runs['cpu64']['ate_lidar']:.4g} m, fused "
          f"{runs['cpu64']['ate_fused']:.4g} m", flush=True)
    band_verdict(runs, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings for the limits of ``correct``: one cell run on many seeds in one
process, by the program or by the control (the reference in TF32 in the
program's place), each with a short window and the benchmark's own check.

    python3 -m vilbench.calibrate --workload <cell> --side program|control \
        --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line per seed with the run's end-to-end metrics, the
numbers compared (``checks``) and every reading of every unit compared,
those that no limit judges too (``units``). The benchmark's runs never
call this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vilbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    def log(msg):
        print(f"[calibrate] {msg}", file=sys.stderr, flush=True)

    if not torch.cuda.is_available():
        print("vilbench.calibrate runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        units: list = []
        res, _ = harness.run(args.workload, seed, args.seconds, False,
                             "cuda:0", side=args.side, log=log,
                             t_start=t0, readings_out=units)
        print(json.dumps(dict(
            workload=args.workload, side=args.side, seed=seed,
            correct=res["correct"], metrics={k: v["value"] for k, v in
                                             res["metrics"].items()},
            checks={k: v["value"] for k, v in res["checks"].items()},
            units=[{k: (statistics.median(v) if isinstance(v, list) and v
                        else v) for k, v in u.items()} for u in units],
            seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

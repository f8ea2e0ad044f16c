"""Run one cell of the benchmark once on the card and print its result.

    python3 -m vilbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Progress and the numbers compared go to
standard error (the numbers compared last); the last line of standard
output is the result, one JSON object. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, a profiler
slice's device busy time and its breakdown. The run refuses to start
without as many CUDA cards as the cell asks for, and prints no result if
JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    print(f"[vilbench +{time.perf_counter() - T_START:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vilbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness

    spec = harness.cell_spec(harness.ROOT, args.workload)
    # Build and kernel caches stay inside the checkout, at fixed paths.
    cache = harness.ROOT / "build" / "vilbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")

    import torch

    torch.set_num_threads(1)   # the host drives the card; one thread
    if not torch.cuda.is_available():
        print("vilbench: no CUDA card is available; the benchmark runs on "
              "one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"vilbench: {args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    log(f"{args.workload} seed {args.seed} for {args.seconds} s, trace "
        f"{args.trace}; torch {torch.__version__}, "
        f"{torch.cuda.get_device_name(0)}")
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda:0", log=log,
                                t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"vilbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

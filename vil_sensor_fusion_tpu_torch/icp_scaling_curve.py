"""Scaling curve of the model-parallel ICP registration
(``parallel.make_sharded_lidar_step``): the real LiDAR odometry step with
its scan-to-map normal equations sharded over worlds of 1, 2, 4 and 8
ranks. The port's counterpart of the repository's
``scripts/icp_scaling_curve.py``.

    python -m vil_sensor_fusion_tpu_torch.icp_scaling_curve
        [--sizes 1,2,4,8] [--device cuda]

Each size is a ``torch.distributed`` world of that many processes, started
here with the ``spawn`` method and joined through a ``file://`` store in a
temporary directory: with ``--device cuda`` one rank per card over NCCL
(which refuses two ranks on one card, so a size needs that many cards),
with ``--device cpu`` gloo processes sharing this host's cores, as the JAX
script's virtual CPU devices do. On one host the CPU curve checks the
sharding and measures the collectives' overhead; it is not a speed-up
claim. Every rank builds the same inputs (the town world of seed 7, two
sweeps 0.4 m apart); each size steps twice, then times ``REPS`` steps
(host clock, ending in a sync). Rank 0's numbers are printed as one JSON
object, ``{"n": {"step_ms", "n_corr", "knn_launches"}}``
(``knn_launches``: the k-NN kernel's launches on rank 0 in that run, 0 on
the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .data import raycast as rc
from .frontends import lidar as L
from .ops import knn as K
from .parallel import make_mesh, make_sharded_lidar_step
from .parallel.mesh import backend_for
from .soak import require_device
from .utils.tracing import block_until_ready as ready

REPS = 5


def problem(device):
    """The config and the two (sweep, pose guess) pairs of the curve."""
    dtype = torch.float32
    w = rc.town_world(n_boxes=24, seed=7, dtype=dtype, device=device)
    p0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 1.5], dtype=dtype, device=device)
    p1 = torch.tensor([1.0, 0, 0, 0, 0.4, 0, 1.5], dtype=dtype, device=device)
    cfg = L.LidarOdomConfig(icp=L.IcpConfig(iters=6, degen_eigval=5.0))
    return cfg, (rc.raycast(w, p0), p0), (rc.raycast(w, p1), p1)


def time_step(mesh, reps: int = REPS) -> dict:
    """On every rank of ``mesh``: the sharded step on the first sweep, then
    ``reps`` timed steps on the second from the state after the first."""
    cfg, first, second = problem(mesh.device)
    step = make_sharded_lidar_step(mesh, cfg)
    st = L.odometry.init(cfg, torch.float32, device=mesh.device)
    st, _ = step(st, *first)
    _, res = ready(step(st, *second))
    t0 = time.perf_counter()
    for _ in range(reps):
        _, res = step(st, *second)
    ready(res)
    dt = (time.perf_counter() - t0) / reps
    return {"step_ms": round(dt * 1e3, 2), "n_corr": float(res.n_corr)}


def _rank(rank: int, world: int, init: str, device_type: str, reps: int,
          out_path: str) -> None:
    """One process of a world of ``world``: a card each (``cuda:rank``) or
    the CPU's cores shared out."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend_for(dev), init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(n_data=1, n_model=world, devices=dev)
        K.KERNEL_LAUNCHES = 0
        row = time_step(mesh, reps)
        row["knn_launches"] = K.KERNEL_LAUNCHES
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(row, f)


def run_size(n: int, device, reps: int = REPS) -> dict:
    """The curve's point at ``n`` ranks: rank 0's row."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        torch.multiprocessing.start_processes(
            _rank, args=(n, f"file://{tmp}/store", torch.device(device).type,
                         reps, out),
            nprocs=n, join=True, start_method="spawn")
        with open(out) as f:
            return json.load(f)


def check_sizes(sizes: list[int], device) -> None:
    """Raise before any run when a size needs more cards than are
    visible."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    have = torch.cuda.device_count()
    if max(sizes) > have:
        raise RuntimeError(
            f"--sizes {','.join(map(str, sizes))} needs {max(sizes)} cards "
            f"(one rank per card: NCCL refuses two ranks on one card); "
            f"{have} visible. Run --sizes 1 on one card, or --device cpu "
            f"for gloo processes on this host's cores")


def main(argv=None, reps: int = REPS) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m vil_sensor_fusion_tpu_torch.icp_scaling_curve",
        description="The sharded LiDAR step over worlds of several ranks.")
    ap.add_argument("--sizes", default="1,2,4,8",
                    help="world sizes to run (default: 1,2,4,8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: one card per rank over NCCL; cpu: gloo "
                         "processes (default: cuda)")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    dev = require_device(args.device, "the ICP scaling curve")
    check_sizes(sizes, dev)
    out = {str(n): run_size(n, dev, reps) for n in sizes}
    print(json.dumps(out, indent=2), flush=True)
    if dev.type == "cpu":
        print("(CPU: the ranks share this host's cores)", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()

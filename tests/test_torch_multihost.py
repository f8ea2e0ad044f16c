"""Multi-process runs of the port on the CPU: gloo worlds of 2 processes
started with ``torch.multiprocessing.spawn``.

- ``multihost.fusion_scaling_workload`` on a world joined through
  ``multihost.initialize`` (a ``tcp://localhost`` rendezvous on a free
  port): a finite events/s over the global batch of both processes.
- ``cli run --model-devices 2`` (``fusion.vil.run_vil(mesh=...)`` under
  it), on a world joined through a ``file://`` store under ``tmp_path``,
  on a tiny recorded bag at narrow maps (the rig of
  ``test_torch_config_cli.py``): rank 0 prints the JSON of
  ``--model-devices 1`` (the ICP's sums split over two processes change
  only their order: the fused ATE within ``ATE_BAND``), rank 1 prints
  nothing.
"""

import contextlib
import io
import json
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vil_sensor_fusion_tpu_torch import cli as TCLI
from vil_sensor_fusion_tpu_torch.parallel import multihost as MH

RANKS = 2
# The CLI runs in float32: a sum split over two ranks rounds otherwise, and
# the fused ATE of a 0.5 s drive moves by far less than this (measured
# below 1e-6 m on these runs).
ATE_BAND = 1e-4

# The CLI runs here: the `cli record` rig's 160×120 camera, narrow maps.
CPU_RUN_YAML = (
    "camera: {width: 160, height: 120, fx: 107.0}\n"
    "vio: {num_landmarks: 12}\n"
    "frontend: {n_candidates: 32, min_dist: 10.0}\n"
    "lidar:\n"
    "  mapping: {iters: 3, degen_eigval: 5.0}\n"
    "  corner_map: {capacity: 4096}\n"
    "  surf_map: {capacity: 8192}\n"
    "  submap_corners: 512\n"
    "  submap_surfs: 1024\n"
    "filter:\n"
    "  rot_degen_threshold: 4.0\n"
    "  trans_degen_threshold: -6.0\n"
    "  normalize_per_corr: true\n"
    "sensors:\n"
    "  vio: {optimize_after_odom: true, covariance_linear: 0.2,\n"
    "        covariance_angular: 0.2, max_time_skip: 0.1}\n"
    "  lidar: {covariance_linear: 0.1, covariance_angular: 0.1,\n"
    "          max_time_skip: 0.2}\n"
    "smoother: {window: 4, between_slots: 8, gn_iters: 3}\n")


def _rank_entry(rank, world, init, fn, args):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks (a ``file://``
    store under ``tmp_path``, no port)."""
    init = f"file://{tmp_path / f'store-{fn.__name__}'}"
    torch.multiprocessing.spawn(_rank_entry, args=(world, init, fn, args),
                                nprocs=world, join=True)


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TCLI.main(argv)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# fusion_scaling_workload over a tcp:// world
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scaling_worker(rank, port, out_path):
    torch.set_num_threads(2)
    MH.initialize(f"localhost:{port}", RANKS, rank, device="cpu")
    try:
        out = MH.fusion_scaling_workload(batch_per_device=1, n_events=6,
                                         n_imu=64, reps=1, device="cpu")
    finally:
        dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


def test_fusion_scaling_workload_on_two_processes(tmp_path):
    torch.multiprocessing.spawn(_scaling_worker,
                                args=(_free_port(), tmp_path / "out"),
                                nprocs=RANKS, join=True)
    outs = []
    for r in range(RANKS):
        with open(tmp_path / f"out.{r}", "rb") as f:
            outs.append(pickle.load(f))
    for events_per_s, global_events in outs:
        # Weak scaling: the global batch spans both processes' lanes.
        assert global_events == RANKS * 1 * 6
        assert np.isfinite(events_per_s) and events_per_s > 0


# ---------------------------------------------------------------------------
# cli run --model-devices 2
# ---------------------------------------------------------------------------

def _cli_worker(rank, runs, out_dir):
    for name, argv in runs.items():
        (out_dir / f"{name}.{rank}.txt").write_text(_cli(argv))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    bag = str(tmp / "town.bag")
    _cli(["record", "--duration", "0.5", "--out", bag, "--device", "cpu"])
    cfg = tmp / "run.yaml"
    cfg.write_text(CPU_RUN_YAML)
    base = ["--config", str(cfg), "--device", "cpu"]
    runs = {
        "bag": ["run", "--bag", bag, *base,
                "--checkpoint", str(tmp / "ck-bag.npz")],
    }
    spawn(_cli_worker, RANKS, tmp,
          {k: v + ["--model-devices", "2"] for k, v in runs.items()}, tmp)
    one = {k: json.loads(_cli(v + ["--model-devices", "1"]))
           for k, v in runs.items()}
    two = {k: [(tmp / f"{k}.{r}.txt").read_text() for r in range(RANKS)]
           for k in runs}
    return one, two


@pytest.mark.parametrize("kind", ["bag"])
def test_cli_run_model_devices_2_matches_1(cli_runs, kind):
    one, two = cli_runs
    assert two[kind][1] == "", "rank 1 printed"
    out = json.loads(two[kind][0])
    assert set(out) == set(one[kind])
    assert out["events"] == one[kind]["events"]
    assert out["healthy_fraction"] == one[kind]["healthy_fraction"] == 1.0
    assert out["gate_keep_fraction"] == one[kind]["gate_keep_fraction"]
    assert abs(out["fused_ate_rmse_m"]
               - one[kind]["fused_ate_rmse_m"]) <= ATE_BAND, (out, one[kind])

"""Multi-host scaling of the data-parallel fusion workload (target: at least
80% of N times one host's events/s at N hosts). The port's counterpart of
the repository's ``scripts/multihost_bench.py``, in its two modes:

- worker: ``python -m vil_sensor_fusion_tpu_torch.multihost_bench worker
  <rank> <ranks> <port> <local_devices> [batch_per_device] [--device cuda]
  [--n-events 48] [--reps 5]`` joins a ``torch.distributed`` world of
  ``ranks`` processes (``parallel.multihost.initialize``, a ``tcp://``
  rendezvous at ``localhost:<port>``) and runs
  ``multihost.fusion_scaling_workload`` over the global data mesh. Rank 0
  prints one JSON line with the global events/s.
- launch: ``python -m vil_sensor_fusion_tpu_torch.multihost_bench launch
  [--hosts 2] [--devices 4] [--device cuda] [--n-events 48] [--reps 5]``
  runs 1 host and ``--hosts`` hosts on this machine and prints the scaling
  table.

Where a JAX process owns several local devices, here a host with D devices
is D processes, one per device (``torchrun``'s layout): the N-host run is
N × D processes, each on a card of its own over NCCL (``--device cuda``;
it raises before starting any process when this machine has fewer cards)
or gloo processes sharing this host's cores (``--device cpu``). Each rank
contributes ``batch_per_device`` sequences (weak scaling), so
``global_events`` = batch × ranks × events. On a real cluster, run the
worker mode once per process with the coordinator's port (or ``torchrun``
with :func:`multihost.initialize`'s arguments).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

from .parallel import multihost as MH
from .soak import require_device

REPO = Path(__file__).resolve().parents[1]
N_EVENTS, REPS = 48, 5       # fusion_scaling_workload's defaults


def worker(argv) -> dict | None:
    """One rank of the world; rank 0 prints and returns its JSON line."""
    ap = argparse.ArgumentParser(prog="multihost_bench worker")
    for name in ("rank", "ranks", "port", "local_devices"):
        ap.add_argument(name, type=int)
    ap.add_argument("batch_per_device", type=int, nargs="?", default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-events", type=int, default=N_EVENTS)
    ap.add_argument("--reps", type=int, default=REPS)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":
        # This process's card: LOCAL_RANK under a launcher, else its place
        # among its host's devices.
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", a.rank % a.local_devices)))
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // a.ranks))
    MH.initialize(f"localhost:{a.port}", a.ranks, a.rank, device=dev)
    try:
        events_per_s, global_events = MH.fusion_scaling_workload(
            batch_per_device=a.batch_per_device, n_events=a.n_events,
            reps=a.reps, device=dev)
    finally:
        torch.distributed.destroy_process_group()
    if a.rank != 0:
        return None
    out = {"processes": a.ranks, "local_devices": a.local_devices,
           "global_events": global_events,
           "events_per_s": round(events_per_s, 1),
           "device": dev.type}
    print(json.dumps(out), flush=True)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_cards(hosts: int, local_devices: int, device) -> None:
    """Raise when ``hosts`` × ``local_devices`` processes, one per card,
    need more cards than this machine has."""
    have = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and hosts * local_devices > have:
        raise RuntimeError(
            f"{hosts} host(s) x {local_devices} device(s) needs "
            f"{hosts * local_devices} cards, one per process; {have} "
            f"visible (--device cpu runs gloo processes)")


def run_cluster(n_procs: int, local_devices: int,
                batch_per_device: int = 1, timeout: int = 900,
                n_events: int = N_EVENTS, reps: int = REPS,
                device="cuda") -> dict:
    """Start ``n_procs`` hosts × ``local_devices`` worker processes on this
    machine; return rank 0's JSON result."""
    ranks = n_procs * local_devices
    dev = torch.device(device)
    check_cards(n_procs, local_devices, dev)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)      # so that -m finds the package
    procs = []
    for i in range(ranks):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "worker", str(i),
             str(ranks), str(port), str(local_devices), str(batch_per_device),
             "--device", dev.type, "--n-events", str(n_events), "--reps",
             str(reps)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, LOCAL_RANK=str(i)), cwd=REPO))
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker {i} failed rc={p.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return json.loads(outs[0].strip().splitlines()[-1])


def launch(argv) -> dict:
    ap = argparse.ArgumentParser(prog="multihost_bench launch")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda: a card per process over NCCL; cpu: gloo "
                         "processes (default: cuda)")
    ap.add_argument("--n-events", type=int, default=N_EVENTS)
    ap.add_argument("--reps", type=int, default=REPS)
    a = ap.parse_args(argv)
    dev = require_device(a.device, "the multi-host bench")
    check_cards(a.hosts, a.devices, dev)
    kw = dict(n_events=a.n_events, reps=a.reps, device=dev)
    one = run_cluster(1, a.devices, **kw)
    many = run_cluster(a.hosts, a.devices, **kw)
    scaling = many["events_per_s"] / (a.hosts * one["events_per_s"])
    out = {
        "single_host": one,
        "multi_host": many,
        "hosts": a.hosts,
        "scaling_efficiency": round(scaling, 3),
        "target": 0.8,
        "meets_target": scaling >= 0.8,
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


def main(argv=None) -> dict | None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "worker":
        return worker(argv[1:])
    return launch(argv[1:] if argv and argv[0] == "launch" else argv)


if __name__ == "__main__":
    main()

"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device: require CUDA; print the card's name and power limit.
2. Build the hand-written k-NN kernel (``csrc/knn.cu``) from source.
3. Kernel vs plain PyTorch (``ops.knn.knn_torch``) on the card, at the four
   k-NN shapes of the main path and at edge cases (ties within and across
   target splits, queries on targets, ragged tiles and splits, M = 1 and a
   whole surf map). Then, per main-path shape, µs per call: the kernel's
   device time (a CUDA graph of 20 launches, replayed), the wrapper's call
   time (back-to-back events) and host time (1,000 calls, no sync), the
   same two for the main path's entry ``knn`` (through the custom op), the
   bound (8 FLOP per pair at 67 TFLOP/s f32), the plain version and the
   library expression (``torch.mm`` + ``torch.topk``, ties aside). The
   same for the kernel's lane entry (``knn_cuda_lanes``: 8 searches of one
   shape in one launch) against ``knn_torch_lanes``: 8 lanes at the four
   bench shapes with a different mask density per lane, a lane with one
   valid target, ties across lanes and splits, every lane also equal bit
   for bit to the single-search kernel on it; times per launch of 8 lanes
   (the entry timed there is ``torch.func.vmap(knn)``) with ``torch.bmm``
   + ``torch.topk`` as the library.
4. The full path at the bench's rig: the 0.8 s ``town`` drive's 16 camera
   frames (800×600, fov 100°) and camera-frame sweep points rendered on the
   card (untimed), then the image tracker (pyramids, detection with LiDAR
   depths, KLT tracking) and ``fusion.vil.run_vil`` (VIO → LiDAR odometry
   → degeneracy gate → fusion), cold and warm. Prints the warm run's
   seconds per stage, the tracker's live share, VIO / LiDAR / fused ATE,
   the gate's keep share and events/s; counts the kernel's launches. Then
   holds the kernel against the plain version again, on the inputs of
   every k-NN call of the cold run (the drive's own masked submaps).
5. The same ``run_vil`` on the scenario's synthetic feature tracks over a
   0.5 s drive, once, with the same checks.
6. CPU cross-check: the first 8 sweeps and 16 frames of phase 4 again on
   the CPU from the card's images, compared with the card's run.
7. Degeneracy experiments: the experiment harness (``eval.experiments``:
   ``experiment_config`` → ``experiment_scenario`` → ``run_scenario``, what
   its ``_run`` composes, with no cache) over the smoke grid's four kinds
   (town, corridor, tunnel, arena; seed 0) at ``ExperimentSpec``'s
   defaults (full motion-distorted VLP-16 sweeps, maps 32,768 / 65,536,
   submaps 4,096 / 8,192, fresh correspondences every GN iteration, the 6×15
   perturbation dists) over ``EXPERIMENT_DURATION`` s each. Per cell:
   events, wall, k-NN launches, ATEs, keep share, median n_corr; then the
   pooled AUC table, the calibrated thresholds and the raw-threshold
   parity. Checks: finite fused poses and fused ATE < 1.0 m in every cell;
   launches per cell equal to the per-sweep count of a CPU run; the kernel
   against ``knn_torch`` on every k-NN call of the corridor cell; the
   corridor's along-axis dist slope below a tenth of the cross-axis ones;
   and a CPU rerun of the corridor's first 5 sweeps / 10 frames from the
   card's inputs (identical NaN/±inf masks on every score series, poses and
   scores within the f32 band).
8. Raw-sensor bag replay through the CLI at the reference rig: a 1 s town
   drive (10 sweeps, 20 frames) rendered on the card at
   ``configs/carla_full.yaml``'s rig (800×600, fov 100°, 24 slots; full
   16×1800 sweeps; maps 32,768 / 65,536; two-stage LOAM, ``fit_every`` 2)
   and written as a bz2 bag by ``scenarios.write_scenario_bag`` (untimed),
   then ``cli.main(["run", "--bag", ..., "--config",
   "configs/carla_full.yaml", "--checkpoint", ...])`` cold on the card,
   timed by stage (ingest = read + ``organize``, tracker, ``run_vil``'s
   four stages). Prints the bag's bytes and message counts, the CLI's
   JSON, seconds, events/s and the k-NN calls per sweep by shape. Checks:
   finite fused poses, healthy share 1.0, fused ATE < 1.0 m (the bound of
   ``tests/test_bag_e2e.py``), gate keep share > 0.5; k-NN launches equal
   to the per-sweep count of a CPU run at the same config; the kernel
   against ``knn_torch`` on every k-NN call of the run; the checkpoint
   restored into a fresh ``fusion.init`` template equal to the final
   engine state bit for bit; the card's ingested sweeps against
   ``ingest.load_bag(..., device="cpu")`` of the same file (masks and xyz
   equal up to ``BAG_EDGE_CELLS``, ranges within an ulp).

9. Lanes and collectives, on a one-rank NCCL mesh of the card
   (``parallel.mesh.make_mesh``): phase 4's first 18 events as 8 lanes
   (the bench's batch; lanes 1-7 with seeded odometry perturbations, each
   a different LiDAR keep mask, the odd ones a dropped VIO frame, so some
   solves are masked per lane) through ``parallel.batched_fusion_run``
   once, then the last lane alone through ``fusion.run``: events/s of
   both; lane 0 against phase 4's fused outputs and the last lane against
   its single run within phase 6's fused tolerances, every pose finite.
   Then ``parallel.make_sharded_lidar_step`` on phase 4's first two sweeps
   over the size-1 model group, equal bit for bit to ``odometry.step``,
   with the kernel against ``knn_torch`` on each of its k-NN calls; and
   ``parallel.windows.solve_sharded`` against ``solve_sequential`` on a
   32-state chain (tests/test_windows_sharding.py's tolerance).
10. Photometric bag replay and the full-batch oracle: phase 8's bag again
   through ``cli.main(["run", "--bag", ..., "--config", <carla_full.yaml
   with vio.use_photometric: true, written under build/>])``: images →
   pyramids and Shi-Tomasi candidates → the direct photometric EKF (no
   KLT), LiDAR odometry, gate, fusion, timed by stage. Checks: finite fused
   poses and VIO covariances with positive diagonals, VIO ATE < 0.5 m
   (``tests/test_photometric.py``'s bound), fused ATE < 1.0 m, live share
   (slots live and passing the χ² gate) over frames 1-19 > 0.5, templates
   captured, keep share > 0.5, k-NN launches equal to phase 8's CPU count,
   the kernel against ``knn_torch`` on every call. Then the photometric VIO
   stage alone on the CPU over the first 5 frames from the card's inputs,
   within ``PHOTO_CROSS_TOL`` (the first frame whose χ² verdicts differ is
   printed); then the oracle report's problem (``oracle_report.build_problem``,
   ``tests/test_batch_oracle.py``'s circle, noise 0) at 4 s in float64 on
   the card against the CPU (``graph.batch.solve_batch``: poses within
   1e-9 m, ``n_between`` equal, cost within 1e-9 relative), and
   ``oracle_report.run_window`` (the fixed-lag ``fusion.run``, window 6) on
   the card over 0.8 s against the oracle of that timeline (the test's
   bounds).
11. Bench lanes: ``cli.main(["bench", "--lanes", "8", "--duration",
   "0.3", "--reps", "1"])`` on the card: 8 town seeds at the bench's rig
   (800×600 camera, full sweeps; 3 sweeps and 6 frames, 9 events per
   lane) through every stage batched over the lanes (``bench.py`` of the
   package: pyramids, candidates, ``track_frames_lanes``,
   ``pipeline.run_lanes``, ``odometry.run_lanes``, ``logdet_gate``,
   ``engine.run_lanes``), a warm and a timed pass, lane 0 alone through the
   single-sequence functions, and the k-NN microbench. Prints events/s,
   pass and single-stream walls, stage ms of both, ATEs per lane. Checks:
   the one stdout JSON line; fused poses finite in every lane; VIO / LiDAR
   ATE < 0.5 m and fused ATE < 1.0 m per lane; k-NN launches, counted over
   the warm pass, over every lane pass and over every single-stream pass,
   = 4 per sweep per pass (one launch for all lanes, not one per lane);
   the lane kernel
   against ``knn_torch_lanes`` on every lane-batched k-NN call of the cold
   pass; lane 0 against its single-stream run within ``CROSS_TOL``.
12. The long-drive soak: ``soak.run_soak`` (the port's
   ``scripts/soak.py``) on the card at its full width (800×600 camera, 24
   landmarks, full 16×1800 sweeps, the soak's rig: ICP 6 / 8 iterations
   with correspondences every 2nd, maps 32,768 / 65,536) over 1 s in two
   0.5 s chunks with the checkpoint test: chunk 1, chunk 2 from the
   carried state, chunk 2 again from the checkpoint restored into a fresh
   template (45 events). Prints the summary and, per chunk, the walls of
   pyramids, detection and the estimator and the real-time factor.
   Checks: every fused pose finite, drift under 5% of the distance,
   healthy share > 0.95, gate keep share > 0.5 (the first sweeps of a
   drive are gated more often than the 20 s test's 0.9 allows), the maps
   populated and within capacity, resume Δ exactly 0; k-NN launches equal
   to a CPU count per sweep of the first chunk's sweeps; the kernel
   against ``knn_torch`` on every k-NN call of the first chunk.
13. The five user scripts, as modules of the port, through their public
   functions at full width with the depth cut: ``profile_stages.run`` at
   400×300 over 4 frames and 2 sweeps, one timed call per row;
   ``lidar_ablation.main`` over 8 town lanes × 0.3 s, all six candidate
   schedules, one timed call each; ``icp_scaling_curve.main(["--sizes",
   "1"])`` (a one-rank NCCL world in a child process);
   ``multihost_bench.run_cluster(1, 1)`` as a worker process at 6 events
   and one timed pass; ``window_sweep_quick.main`` at 0.3 s, window 4, in
   float64. The curve and the bench's worker, which start processes, run
   in two threads beside the other three. Checks: every time and pose finite; the ablation's error max
   < 0.5 m for every candidate, the window sweep's ATE < 0.05 m, the
   curve's ``n_corr`` > 0, the bench's ``global_events`` = batch × ranks
   × events; the k-NN launches of the profile (per row), the ablation (per
   sweep per candidate, one launch for all lanes) and the curve (in its
   child) equal to a CPU count of the same calls; the kernel against
   ``knn_torch`` on every k-NN call of the profile's map-stage register
   row, and against ``knn_torch_lanes`` on every lane call of the first
   candidate's first call.
14. The thesis's evaluation grid: ``eval.experiments.run_batch`` over
   ``default_grid`` (tunnel, field; seed 0, as ``cli experiments --seeds
   1``) at 0.6 s per cell, with what ``cli experiments`` reports computed
   without its figures (the card's host has no matplotlib): per cell and
   pooled, the AUC of every score on its typed labels, the calibrated
   thresholds, the raw-threshold parity. The tunnel is phase 7's cell (the
   same spec), which phase 7 writes into the experiment cache, so only the
   field runs; phase 7 also drove its kernel, ATEs and CPU rerun. Per run
   cell: walls, events/s, k-NN launches, ATEs, keep share, and per voxel
   map its fill against capacity and the first sweep that evicted a live
   slot beyond ``keep_radius``. Checks: finite fused poses and fused ATE <
   1.0 m in every cell; the field's launches equal to the CPU's per-sweep
   count; the kernel against ``knn_torch`` on every k-NN call of the field
   cell; the field's first 5 sweeps / 10 frames again on the CPU in
   float32 from the card's scenario, within phase 7's tolerances with
   identical NaN / ±inf score masks. ``eval_grid(15.0)`` runs this phase
   alone with every cell run, and ``bag_replays(5.0)`` phases 8 and 10's
   replays on a 5 s bag.

After phase 14 a ``[phase seconds]`` line gives each phase's wall. The
last two lines are a JSON object describing the kernels (one sweep's
sums in ms: ``ms`` the wrapper's call time, ``device_ms`` the kernel's
own; per-shape µs under ``per_shape_us``; launches per driven path; the
kernel's ms per experiment, bag-replay and soak sweep; the card; and
the lane entry ``knn5_f32_lanes`` with one 8-lane bench sweep's sums and
the launches of the bench lanes and the ablation) and
``{"ok": true, "device": {...}}``. Nothing here imports JAX. The stages
are timed with the port's ``utils.tracing.StageTimer``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import statistics
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from vil_sensor_fusion_tpu_torch import _build, _precision, _tree
from vil_sensor_fusion_tpu_torch import cli
from vil_sensor_fusion_tpu_torch import config as C
from vil_sensor_fusion_tpu_torch import fusion as fu
from vil_sensor_fusion_tpu_torch import graph as G
from vil_sensor_fusion_tpu_torch import utils as U
from vil_sensor_fusion_tpu_torch.bench import knn_library
from vil_sensor_fusion_tpu_torch.core import lie
from vil_sensor_fusion_tpu_torch.data import ingest as IG
from vil_sensor_fusion_tpu_torch.data import scenarios
from vil_sensor_fusion_tpu_torch.data.rosbag_io import BagReader
from vil_sensor_fusion_tpu_torch.degeneracy import gate as DG
from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.eval import roc as R
from vil_sensor_fusion_tpu_torch.frontends import lidar as L
from vil_sensor_fusion_tpu_torch.frontends import vio as V
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as vm
from vil_sensor_fusion_tpu_torch.frontends.vio import frontend as F
from vil_sensor_fusion_tpu_torch.fusion import vil as VIL
from vil_sensor_fusion_tpu_torch.ops import knn as K
from vil_sensor_fusion_tpu_torch.parallel import mesh as PM
from vil_sensor_fusion_tpu_torch.parallel import ops as POPS
from vil_sensor_fusion_tpu_torch.parallel import windows as PW
from vil_sensor_fusion_tpu_torch.soak import card_line

# The four k-NN launches of one sweep (Q queries × M targets): line and
# plane fits of the scan-to-scan stage, then of the scan-to-map stage.
MAIN_PATH_SHAPES = ((192, 1920), (384, 3984), (1920, 2048), (3984, 4096))
# The experiment harness's scan-to-map searches, against its default
# submaps 4,096 / 8,192 (its scan-to-scan ones are the first two above).
EXPERIMENT_SHAPES = ((1920, 4096), (3984, 8192))
# Depths, cut so the script stays well inside its 600 s: the town drive
# from 4 s to 2 s and, once phase 8 came (whose first whole run took 586 s
# on an H100 host where the engine ran 1.5 times slower than before), to
# 1.5 s, and to 1.0 s when phase 12 came (phase 6 still reruns its 10
# sweeps, phase 9 its first 18 events); the synthetic-track drive from 1 s
# to 0.5 s; the experiment cells from 1.5 s to 1.2 s (a tunnel cell under
# 6 s labels at most one sweep either way; the corridor and the arena give
# the pooled labels both classes), and to 1.0 s when phase 13 came (a CPU
# build of the smoke grid at 1.0 s still labels the corridor's 10 sweeps
# translation-degenerate, the arena's rotation-degenerate and one tunnel
# sweep, so both pooled label sets keep both classes; phase 7 checks
# that); phase 11's bench lanes from 0.6 s to 0.4 s when phase 12 came.
# When phase 14 came (a whole run took 639 s on an H100 host whose CPU
# reruns were 2.5 times slower than before, and 534 s from git archive
# after the first cuts): the experiment cells to 0.8 s and then 0.6 s
# (the corridor's sweeps all translation-degenerate and the arena's all
# rotation-degenerate keep both pooled label sets two-class; the CPU
# reruns keep their 5 sweeps), the town drive to 0.8 s with phase 6
# rerunning its 8 sweeps (phase 9 still takes its first 18 of 24 events),
# phase 10's fixed-lag replay from 1.5 s to 0.8 s, phase 11's bench lanes
# from 0.4 s to 0.3 s.
EXPERIMENT_DURATION = 0.6   # s per experiment cell: 6 sweeps, 12 frames
CROSS_EXP_SWEEPS = 5        # corridor sweeps (and 10 frames) rerun on the CPU
DURATION = 0.8          # s of the town drive: 8 sweeps, 16 VIO frames
SHORT_DURATION = 0.5    # s of the synthetic-track drive: 5 sweeps
CROSS_SWEEPS = 8        # sweeps (and their 16 frames) rerun on the CPU
CAM_W, CAM_H = 800, 600  # the bench's camera (bench.py)
N_SLOTS = 24            # VIO landmark slots: EKF state 15 + 3·24 = 87
SWEEP_STRIDE = 4        # azimuth decimation: 16·1800/4 = 7,200 points


class Failed(Exception):
    """A phase's check did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# --------------------------------------------------------------------------
# Phase 3: kernel vs plain
# --------------------------------------------------------------------------

def _cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_turns(fns: dict, rounds: int = 6, reps: int = 20) -> dict:
    """Median ms per call of each function, ``reps`` back-to-back calls
    timed with events, the functions in turns (forward, then backward
    order) after a warm-up."""
    for f in fns.values():
        for _ in range(3):
            f()
    torch.cuda.synchronize()
    acc = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            acc[k].append(_cuda_ms(fns[k], reps))
    return {k: statistics.median(v) for k, v in acc.items()}


def graph_ms(fn, launches: int = 20, replays: int = 10,
             rounds: int = 6) -> float:
    """The device's ms per call: ``launches`` calls captured in one CUDA
    graph, replayed back to back and timed with events, so the host's
    enqueue time is out of the reading. Median of ``rounds``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        out.append(_cuda_ms(g.replay, replays) / launches)
    del g
    return statistics.median(out)


def host_ms(fn, calls: int = 1000) -> float:
    """The host's ms per call: ``calls`` calls enqueued with no
    synchronisation between them, host clock; one sync after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): f32 outside
# the tensor cores, and HBM3.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def knn_bound_ms(Q: int, M: int, B: int = 1) -> tuple[float, str]:
    """The least time the card could take for B k=5 searches: 8 FLOP per
    (query, target) pair (3 for q·t's products, 2 adds, one FMA for
    ‖q‖² − 2q·t, one add of ‖t‖²) in f32, against reading queries (12 B),
    targets and mask (16 B) once and writing 5 int32 + 5 f32 per query."""
    ops_ms = 8.0 * Q * M * B / F32_FLOPS * 1e3
    bytes_ms = B * (12.0 * Q + 16.0 * M + 40.0 * Q) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _map_cloud(n: int, g: torch.Generator) -> torch.Tensor:
    """Points in a 40 m box about 100 m from the origin, as map
    coordinates are."""
    return torch.rand(n, 3, generator=g) * 40.0 + 100.0


def one_past(Q0: int, M0: int) -> tuple[int, int]:
    """The first (Q, M) from (Q0, M0) up with Q one past a query tile and
    M one past a split boundary: M − 1 targets fill the plan's splits
    exactly, so the M-th starts a ragged re-plan."""
    Q = next(Q for Q in range(Q0, Q0 + 65)
             if (Q - 1) % K._plan(Q, M0).query_tile == 0)
    full = lambda p, n: p.n_splits > 1 and n == p.n_splits * p.split_len
    M = next(M for M in range(M0, 2 * M0)
             if full(K._plan(Q, M - 1), M - 1))
    return Q, M


# Queries placed on targets (on_target), and on targets copied into
# another split (split_tie).
SEL_ON_TARGET = torch.arange(64) * 31 + 5
SEL_SPLIT_TIE = torch.tensor([0, 3, 64, 500, 1023, 1024, 1500, 2047])


def knn_cases(g: torch.Generator) -> list[tuple[str, torch.Tensor,
                                                torch.Tensor, torch.Tensor]]:
    cases = []
    for Q, M in MAIN_PATH_SHAPES + EXPERIMENT_SHAPES:
        q, t = _map_cloud(Q, g), _map_cloud(M, g)
        m = (torch.rand(M, generator=g) > 0.05).float()
        cases.append((f"main_{Q}x{M}", q, t, m))
    q, t = _map_cloud(77, g), _map_cloud(4097, g)       # one past a tile
    cases.append(("ragged_77x4097", q, t, torch.ones(4097)))
    for Q0, M0 in MAIN_PATH_SHAPES[:2]:                 # one past a split
        Q, M = one_past(Q0, M0)
        cases.append((f"one_past_{Q}x{M}", _map_cloud(Q, g), _map_cloud(M, g),
                      (torch.rand(M, generator=g) > 0.05).float()))
    q, t = _map_cloud(1000, g), _map_cloud(3000, g)
    cases.append(("masked30_1000x3000", q, t,
                  (torch.rand(3000, generator=g) > 0.3).float()))
    q, t = _map_cloud(33, g), _map_cloud(16, g)
    m = torch.zeros(16)
    m[[2, 9, 11]] = 1.0
    cases.append(("three_valid_33x16", q, t, m))
    base = _map_cloud(300, g)
    t = torch.cat([base, base.flip(0), base[:50]])      # exact duplicates
    q = base[:200] + 0.05 * torch.randn(200, 3, generator=g)
    cases.append(("duplicates_200x650", q, t, torch.ones(650)))
    t = torch.full((64, 3), 101.5)                      # all targets equal
    m = torch.ones(64)
    m[[0, 2]] = 0.0
    cases.append(("all_equal_5x64", _map_cloud(5, g), t, m))
    cases.append(("single_query_1x4096", _map_cloud(1, g), _map_cloud(4096, g),
                  torch.ones(4096)))
    cases.append(("one_target_64x1", _map_cloud(64, g), _map_cloud(1, g),
                  torch.ones(1)))
    # Queries equal to targets at 100 m: ‖q‖² − 2q·t + ‖t‖² cancels to a
    # few ulps either side of 0, so negative distances are ranked.
    t = _map_cloud(2048, g)
    cases.append(("on_target_64x2048", t[SEL_ON_TARGET], t, torch.ones(2048)))
    # Each query sits on a target copied 2,048 places on, into another
    # target split: the tie must go to the lower index.
    t = _map_cloud(4096, g)
    t[2048 + SEL_SPLIT_TIE] = t[SEL_SPLIT_TIE]
    cases.append(("split_tie_8x4096", t[SEL_SPLIT_TIE], t, torch.ones(4096)))
    # The scan-to-map queries against a whole surf map (its capacity).
    cases.append(("surf_map_3984x49152", _map_cloud(3984, g),
                  _map_cloud(49152, g),
                  (torch.rand(49152, generator=g) > 0.5).float()))
    return cases


def compare_knn(name: str, q, t, m) -> tuple:
    """Hold the kernel against knn_torch on one input on the card: the
    +inf pattern, |Δd²| within tol, indices in [0, M), ascending
    distances, equal indices wherever neighbours are separated, exact ties
    to the lower index. Returns (kernel idx, plain idx, |Δd²|, tol,
    separated slots)."""
    i_k, d_k = K.knn_cuda(q, t, m)
    torch.cuda.synchronize()
    # The plain version's 6th neighbour gives the gap after the 5th.
    i_p6, d_p6 = K.knn_torch(q, t, m, k=6)
    torch.cuda.synchronize()
    err, tol, sep = check_knn_result(name, q, t, m, i_k, d_k, i_p6, d_p6)
    return i_k, i_p6[:, :5], err, tol, sep


def compare_knn_lanes(name: str, q, t, m) -> tuple:
    """Hold the lane kernel (one launch for the B lanes of (B, Q, 3)
    queries, (B, M, 3) targets, (B, M) masks) against ``knn_torch_lanes``
    with :func:`check_knn_result`'s checks in every lane, and every lane
    equal bit for bit to the single-search kernel on that lane alone (a
    result does not depend on the grid). Returns (kernel idx, plain idx,
    largest |Δd²|, largest tol, separated slots)."""
    i_k, d_k = K.knn_cuda_lanes(q, t, m)
    torch.cuda.synchronize()
    i_p6, d_p6 = K.knn_torch_lanes(q, t, m, k=6)
    torch.cuda.synchronize()
    errs, tols, seps = [], [], []
    for b in range(q.shape[0]):
        err, tol, sep = check_knn_result(f"{name} lane {b}", q[b], t[b],
                                         m[b], i_k[b], d_k[b], i_p6[b],
                                         d_p6[b])
        i_1, d_1 = K.knn_cuda(q[b], t[b], m[b])
        check(torch.equal(i_1, i_k[b]) and torch.equal(d_1, d_k[b]),
              f"{name} lane {b}: the lane kernel differs from the single "
              "search on that lane")
        errs.append(err)
        tols.append(tol)
        seps.append(sep)
    return i_k, i_p6[..., :5], max(errs), max(tols), torch.stack(seps)


def check_knn_result(name: str, q, t, m, i_k, d_k, i_p6, d_p6) -> tuple:
    """:func:`compare_knn`'s checks on the kernel's (idx, d²) of one search
    against the plain version's 6 nearest. Returns (|Δd²|, tol,
    separated slots)."""
    M = t.shape[0]
    i_p, d_p = i_p6[:, :5], d_p6[:, :5]
    # Both sides evaluate ‖q‖² − 2q·t + ‖t‖² in f32 but sum in another
    # order, so a distance may move by a few ulps of its largest term:
    # tol = 4 ulps of max ‖q‖² + max ‖t‖² (~0.05 m² at 100 m offsets).
    eps = torch.finfo(torch.float32).eps
    tol = 4 * eps * float((q * q).sum(1).max() + (t * t).sum(1).max())
    fin = torch.isfinite(d_p)
    check(bool((torch.isfinite(d_k) == fin).all()),
          f"{name}: +inf pattern differs from the plain version")
    err = float((d_k - d_p)[fin].abs().max()) if fin.any() else 0.0
    check(err <= tol, f"{name}: dist² differs by {err} > {tol}")
    check(bool(((i_k >= 0) & (i_k < M)).all()),
          f"{name}: index outside [0, {M})")
    check(bool((d_k[:, 1:] >= d_k[:, :-1]).all()),
          f"{name}: distances not ascending")
    gaps = torch.diff(d_p6, dim=1)            # (Q, 5): d[j+1] − d[j]
    prev = torch.cat([torch.full_like(gaps[:, :1], torch.inf),
                      gaps[:, :4]], 1)
    sep = fin & (prev > tol) & (gaps > tol)
    check(bool((i_k[sep] == i_p[sep]).all()),
          f"{name}: indices differ where neighbours are separated")
    tie = d_k[:, 1:] == d_k[:, :-1]
    check(bool((i_k[:, 1:] > i_k[:, :-1])[tie & fin[:, 1:]].all()),
          f"{name}: an exact tie kept the higher index first")
    return err, tol, sep


def check_knn_cases(dev: torch.device) -> float:
    """Hold the kernel against knn_torch on the card at every case; return
    the largest |Δd²| where both are finite."""
    g = torch.Generator().manual_seed(1)
    max_err = 0.0
    for name, q, t, m in knn_cases(g):
        q, t, m = q.to(dev), t.to(dev), m.to(dev)
        i_k, i_p, err, tol, _ = compare_knn(name, q, t, m)
        if name.startswith("all_equal"):
            want = torch.tensor([1, 3, 4, 5, 6], dtype=torch.int32,
                                device=dev).expand_as(i_k)
            check(bool((i_k == want).all()) and bool((i_p == want).all()),
                  f"{name}: ties must go to the lowest valid index")
        if name.startswith("on_target"):
            check(bool((i_k[:, 0].cpu() == SEL_ON_TARGET).all()),
                  f"{name}: a query's own target is not its nearest")
        if name.startswith("split_tie"):
            want = torch.stack([SEL_SPLIT_TIE, SEL_SPLIT_TIE + 2048], 1)
            check(torch.equal(i_k[:, :2].cpu().long(), want),
                  f"{name}: the tie across splits kept the higher index")
        max_err = max(max_err, err)
        print(f"  {name:24s} ok   max|Δd²| {err:.3g}  (tol {tol:.3g})",
              flush=True)
    # The wrapper refuses what the kernel does not take.
    q, t, m = (torch.rand(8, 3, device=dev), torch.rand(16, 3, device=dev),
               torch.ones(16, device=dev))
    for bad in (lambda: K.knn_cuda(q.double(), t.double(), m.double()),
                lambda: K.knn_cuda(q, t, m, k=4),
                lambda: K.knn_cuda(q.t().contiguous().t(), t, m),
                lambda: K.knn_cuda(q, t.cpu(), m)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise Failed("knn_cuda accepted an input it must refuse")
    return max_err


KNN_LANES = 8           # the bench's lanes (bench.py:64)
ONE_VALID_LANE, ONE_VALID_TARGET = 5, 1234


def knn_lane_cases(g: torch.Generator) -> list[tuple[str, torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]]:
    """Lane cases of the kernel: (B, Q, 3), (B, M, 3), (B, M) inputs."""
    B = KNN_LANES
    lanes = lambda f: torch.stack([f(b) for b in range(B)])
    cases = []
    # The bench's four shapes, each lane its own clouds and its own mask
    # density (5% to 75% of the targets masked).
    for Q, M in MAIN_PATH_SHAPES:
        cases.append((f"lanes{B}_{Q}x{M}", lanes(lambda b: _map_cloud(Q, g)),
                      lanes(lambda b: _map_cloud(M, g)),
                      lanes(lambda b: (torch.rand(M, generator=g)
                                       > 0.05 + 0.1 * b).float())))
    # One lane with a single valid target, the others full.
    Q, M = MAIN_PATH_SHAPES[1]
    m = torch.ones(B, M)
    m[ONE_VALID_LANE] = 0.0
    m[ONE_VALID_LANE, ONE_VALID_TARGET] = 1.0
    cases.append((f"lanes{B}_one_valid_{Q}x{M}",
                  lanes(lambda b: _map_cloud(Q, g)),
                  lanes(lambda b: _map_cloud(M, g)), m))
    # Ties across lanes and splits: every lane holds the same map but
    # copies its own targets (tie_sel(b)) 2,048 places on, into another
    # split; each query sits on one of its lane's copied targets.
    base = _map_cloud(4096, g)

    def tie_map(b):
        t = base.clone()
        t[2048 + tie_sel(b)] = t[tie_sel(b)]
        return t
    t = lanes(tie_map)
    cases.append((f"lanes{B}_split_tie_8x4096",
                  lanes(lambda b: t[b, tie_sel(b)]), t, torch.ones(B, 4096)))
    return cases


def tie_sel(b: int) -> torch.Tensor:
    """Lane b's tied targets: SEL_SPLIT_TIE moved b places within the
    first 2,048."""
    return (SEL_SPLIT_TIE + b) % 2048


def check_knn_lane_cases(dev: torch.device) -> float:
    """Hold the lane kernel against knn_torch_lanes (and each lane against
    the single-search kernel) at every lane case; return the largest
    |Δd²|."""
    g = torch.Generator().manual_seed(3)
    max_err = 0.0
    for name, q, t, m in knn_lane_cases(g):
        q, t, m = q.to(dev), t.to(dev), m.to(dev)
        i_k, _, err, tol, _ = compare_knn_lanes(name, q, t, m)
        B = q.shape[0]
        if "one_valid" in name:
            lane = i_k[ONE_VALID_LANE].cpu()
            check(bool((lane[:, 0] == ONE_VALID_TARGET).all())
                  and bool((lane[:, 1:] == 0).all()),
                  f"{name}: the lane with one valid target")
        if "split_tie" in name:
            sel = torch.stack([tie_sel(b) for b in range(B)])
            want = torch.stack([sel, sel + 2048], -1)
            check(torch.equal(i_k[..., :2].cpu().long(), want),
                  f"{name}: a tie across splits kept the higher index")
        max_err = max(max_err, err)
        print(f"  {name:28s} ok   max|Δd²| {err:.3g}  (tol {tol:.3g}), "
              f"every lane = its single search", flush=True)
    # The lane wrapper refuses what the kernel does not take: more than
    # 65,535 (lane, query tile) pairs, CPU tensors, a missing lane axis.
    q, t, m = (torch.zeros(600, 2000, 3, device=dev),
               torch.zeros(600, 64, 3, device=dev),
               torch.ones(600, 64, device=dev))
    for bad in (lambda: K.knn_cuda_lanes(q, t, m),
                lambda: K.knn_cuda_lanes(q[:2].cpu(), t[:2].cpu(),
                                         m[:2].cpu()),
                lambda: K.knn_cuda_lanes(q[0], t[0], m[0])):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise Failed("knn_cuda_lanes accepted an input it must refuse")
    return max_err


def knn_library_lanes(q, t, m, k: int = 5):
    """:func:`knn_library` over a lane axis: ``torch.bmm`` + ``torch.topk``
    (a yardstick only)."""
    d = ((q * q).sum(-1, keepdim=True) - 2.0 * torch.bmm(q, t.mT)
         + torch.where(m > 0, (t * t).sum(-1), torch.inf)[:, None])
    dist, idx = torch.topk(d, k, dim=-1, largest=False)
    return idx, dist


def time_knn_lane_shapes(dev: torch.device, B: int = KNN_LANES) -> dict:
    """Per bench shape, µs per call of B lanes in one launch: device time
    (CUDA graph), call and host time, the bound (B searches), the plain
    twin ``knn_torch_lanes`` and the library (``torch.bmm`` +
    ``torch.topk``)."""
    g = torch.Generator().manual_seed(4)
    out = {}
    for Q, M in MAIN_PATH_SHAPES:
        q = torch.stack([_map_cloud(Q, g) for _ in range(B)]).to(dev)
        t = torch.stack([_map_cloud(M, g) for _ in range(B)]).to(dev)
        m = (torch.rand(B, M, generator=g) > 0.05).float().to(dev)
        kern = lambda: K.knn_cuda_lanes(q, t, m)
        entry = lambda: torch.func.vmap(K.knn)(q, t, m)
        ev = time_turns({"call": kern, "entry": entry,
                         "plain": lambda: K.knn_torch_lanes(q, t, m),
                         "library": lambda: knn_library_lanes(q, t, m)})
        bound, bound_by = knn_bound_ms(Q, M, B)
        row = {"lanes": B, "device_us": graph_ms(kern) * 1e3,
               "call_us": ev["call"] * 1e3, "host_us": host_ms(kern) * 1e3,
               "entry_call_us": ev["entry"] * 1e3,
               "entry_host_us": host_ms(entry) * 1e3,
               "bound_us": bound * 1e3, "bound_by": bound_by,
               "plain_us": ev["plain"] * 1e3,
               "library_us": ev["library"] * 1e3}
        row["roofline_share"] = row["bound_us"] / row["device_us"]
        out[f"{B}x{Q}x{M}"] = row
        print(f"  {B}x{Q:5d}x{M:<5d} device {row['device_us']:8.2f}  call "
              f"{row['call_us']:8.2f}  host {row['host_us']:7.2f}  vmap(knn) "
              f"call {row['entry_call_us']:8.2f} host "
              f"{row['entry_host_us']:7.2f}  bound "
              f"{row['bound_us']:6.3f} ({100 * row['roofline_share']:.1f}%)  "
              f"library {row['library_us']:8.2f}  plain "
              f"{row['plain_us']:8.2f}  us", flush=True)
    return out


def time_knn_shapes(dev: torch.device) -> dict:
    """Per main-path shape, µs per call: the kernel's device time (CUDA
    graph), the wrapper's call time (back-to-back events) and host time,
    the bound, the plain version and the library expression."""
    g = torch.Generator().manual_seed(2)
    out = {}
    for Q, M in MAIN_PATH_SHAPES + EXPERIMENT_SHAPES:
        q, t = _map_cloud(Q, g).to(dev), _map_cloud(M, g).to(dev)
        m = (torch.rand(M, generator=g) > 0.05).float().to(dev)
        kern = lambda: K.knn_cuda(q, t, m)
        entry = lambda: K.knn(q, t, m)
        ev = time_turns({"call": kern, "entry": entry,
                         "plain": lambda: K.knn_torch(q, t, m),
                         "library": lambda: knn_library(q, t, m)})
        bound, bound_by = knn_bound_ms(Q, M)
        row = {"device_us": graph_ms(kern) * 1e3,
               "call_us": ev["call"] * 1e3, "host_us": host_ms(kern) * 1e3,
               "entry_call_us": ev["entry"] * 1e3,
               "entry_host_us": host_ms(entry) * 1e3,
               "bound_us": bound * 1e3, "bound_by": bound_by,
               "plain_us": ev["plain"] * 1e3,
               "library_us": ev["library"] * 1e3}
        row["roofline_share"] = row["bound_us"] / row["device_us"]
        out[f"{Q}x{M}"] = row
        print(f"  {Q:5d}x{M:<5d} device {row['device_us']:8.2f}  call "
              f"{row['call_us']:8.2f}  host {row['host_us']:7.2f}  knn call "
              f"{row['entry_call_us']:8.2f} host {row['entry_host_us']:7.2f}"
              f"  bound "
              f"{row['bound_us']:6.3f} ({100 * row['roofline_share']:.1f}%)  "
              f"library {row['library_us']:8.2f}  plain "
              f"{row['plain_us']:8.2f}  us", flush=True)
    return out


def kernels_line(card: str, launches: dict, max_err: float,
                 shapes: dict, experiment_sweep: dict,
                 bag_sweep: dict, soak_sweep: dict, lane_launches: dict,
                 lane_max_err: float,
                 lane_shapes: dict) -> str:
    """The JSON ``kernels`` line: one bench sweep's sums of its four shapes
    in ms (``ms`` the wrapper's call time, as in earlier lines;
    ``device_ms`` the kernel's own), the per-shape µs, the launches of each
    driven path (``launches`` their sum), and the kernel's device and call
    ms per experiment sweep, per bag-replay sweep and per soak sweep from
    their calls per sweep by shape. A second entry, ``knn5_f32_lanes``, is the same kernel
    through its lane entry (``knn_cuda_lanes``, one launch for 8 lanes):
    one bench sweep of 8 lanes, its launches on the lane path."""
    bench = {f"{Q}x{M}": shapes[f"{Q}x{M}"] for Q, M in MAIN_PATH_SHAPES}
    total = lambda key: sum(r[key] for r in bench.values()) * 1e-3
    per_sweep = lambda calls: {
        "calls": calls,
        "device_ms": sum(n * shapes[k]["device_us"]
                         for k, n in calls.items()) * 1e-3,
        "call_ms": sum(n * shapes[k]["call_us"]
                       for k, n in calls.items()) * 1e-3}
    return json.dumps({"kernels": [{
        "name": "knn5_f32", "route": "cuda",
        "source": "vil_sensor_fusion_tpu_torch/csrc/knn.cu",
        "replaces": "vil_sensor_fusion_tpu/ops/knn.py:114",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max_err,
        "ms": total("call_us"), "plain_ms": total("plain_us"),
        "bound_ms": total("bound_us"), "bound_by": "operations",
        "library_ms": total("library_us"),
        "library_call": "torch.mm + torch.topk (ties aside)",
        "ms_of": "one sweep: sum of the 4 main-path shapes; ms is the "
                 "wrapper's call time (20 back-to-back calls, CUDA events), "
                 "device_ms the kernel's own (a CUDA graph of 20 launches), "
                 "host_ms the host's per call",
        "device_ms": total("device_us"), "host_ms": total("host_us"),
        "per_shape_us": shapes,
        "experiment_sweep": per_sweep(experiment_sweep),
        "bag_sweep": per_sweep(bag_sweep),
        "soak_sweep": per_sweep(soak_sweep),
        "card": card}, {
        "name": "knn5_f32_lanes", "route": "cuda",
        "source": "vil_sensor_fusion_tpu_torch/csrc/knn.cu",
        "replaces": "vil_sensor_fusion_tpu/ops/knn.py:114",
        "launches": sum(lane_launches.values()),
        "launches_by_path": lane_launches,
        "max_abs_err": lane_max_err,
        "ms": sum(r["call_us"] for r in lane_shapes.values()) * 1e-3,
        "plain_ms": sum(r["plain_us"] for r in lane_shapes.values()) * 1e-3,
        "bound_ms": sum(r["bound_us"] for r in lane_shapes.values()) * 1e-3,
        "bound_by": "operations",
        "library_ms":
            sum(r["library_us"] for r in lane_shapes.values()) * 1e-3,
        "library_call": "torch.bmm + torch.topk (ties aside)",
        "plain_call": "knn_torch_lanes (knn_torch per lane)",
        "ms_of": f"one bench sweep of {KNN_LANES} lanes: sum of the 4 "
                 "main-path shapes, one launch each; timed as the single "
                 "entry's",
        "device_ms":
            sum(r["device_us"] for r in lane_shapes.values()) * 1e-3,
        "host_ms": sum(r["host_us"] for r in lane_shapes.values()) * 1e-3,
        "per_shape_us": lane_shapes,
        "card": card}]})


# --------------------------------------------------------------------------
# Phases 4-6: the full path
# --------------------------------------------------------------------------

def main_path_config() -> tuple[VIL.VilConfig, F.FrontendConfig]:
    """The bench's rig and operating point (bench.py), one sequence: the
    800×600 fov-100° camera with 24 landmark slots, and the LiDAR, gate and
    fusion settings of the bench."""
    cam = V.camera.carla_camera(width=CAM_W, height=CAM_H)
    pose_ic = tuple(float(v) for v in
                    F.forward_camera_extrinsics(torch.float64))
    vio = V.VioConfig(num_landmarks=N_SLOTS, update_iters=2, cam=cam,
                      pose_ic=pose_ic)
    frontend = F.FrontendConfig(cam=cam, n_candidates=64, min_dist=24.0,
                                min_score=0.5)
    lidar = L.LidarOdomConfig(
        icp=L.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                        final_refresh=False, eig_sweeps=3),
        odom_icp=L.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                             fit_every=4, final_refresh=False, eig_sweeps=3),
        corner_map=vm.VoxelMapConfig(capacity=24576, leaf=0.2),
        surf_map=vm.VoxelMapConfig(capacity=49152, leaf=0.4),
        submap_corners=2048, submap_surfs=4096,
        two_stage=True, undistort=True, guess_is_delta=True)
    cfg = VIL.VilConfig(
        vio=vio, lidar=lidar,
        gate=DG.GateConfig(4.0, -6.0, normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
            sensors=VIL.VilConfig().fusion.sensors, max_imu_per_gap=32))
    return cfg, frontend


class DriveInputs(NamedTuple):
    """One drive's inputs. The VIO input is either the camera stream
    (``images``, ``cam_points``, ``cam_point_valid``, run through the
    tracker) or ready feature tracks (``frames``)."""

    imu_times: torch.Tensor
    imu_accel: torch.Tensor
    imu_gyro: torch.Tensor
    vio_times: np.ndarray
    imu_windows: tuple              # (accel, gyro, dts), (T_v, N, ·)
    images: torch.Tensor | None     # (T_v, H, W)
    cam_points: torch.Tensor | None  # (T_v, P, 3)
    cam_point_valid: torch.Tensor | None
    frames: V.VioFrameInput | None
    pose0: torch.Tensor
    vel0: torch.Tensor
    lidar_times: np.ndarray
    sweeps: L.Sweep
    guess_idx: np.ndarray


def make_inputs(cfg: VIL.VilConfig, dev, duration: float,
                from_images: bool, seed: int = 0):
    """The town drive on ``dev``. With ``from_images`` its camera stream
    and camera-frame sweep points are rendered on ``dev`` too (untimed);
    otherwise the VIO gets the scenario's synthetic feature tracks."""
    sc = scenarios.build("town", duration=duration, vio_cfg=cfg.vio,
                         dtype=torch.float32, device=dev, seed=seed)
    images = pts = msk = None
    if from_images:
        sync = _sync_of(dev)
        sync()
        t0 = time.perf_counter()
        images, pts, msk = scenarios.render_frontend_inputs(
            sc, cfg.vio.cam, cfg.vio.pose_ic, sweep_stride=SWEEP_STRIDE)
        sync()
        print(f"  rendered {tuple(images.shape)} frames and "
              f"{tuple(pts.shape)} camera-frame sweep points in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    f = sc.vio_frames
    t0 = torch.zeros((), dtype=torch.float32, device=dev)
    x = DriveInputs(
        imu_times=sc.imu_times, imu_accel=sc.imu_accel, imu_gyro=sc.imu_gyro,
        vio_times=sc.vio_times, imu_windows=(f.accel, f.gyro, f.dts),
        images=images, cam_points=pts, cam_point_valid=msk,
        frames=None if from_images else f,
        pose0=sc.traj.pose_fn(t0), vel0=sc.traj.vel_fn(t0),
        lidar_times=sc.lidar_times, sweeps=sc.sweeps,
        guess_idx=sc.lidar_guess_idx)
    return sc, x


def first_events(x: DriveInputs, n: int) -> DriveInputs:
    """The first ``n`` sweeps and the VIO frames up to the last of them."""
    nv = int(np.searchsorted(x.vio_times, x.lidar_times[n - 1] + 1e-9))
    cut = lambda v: None if v is None else v[:nv]
    return x._replace(
        vio_times=x.vio_times[:nv],
        imu_windows=tuple(w[:nv] for w in x.imu_windows),
        images=cut(x.images), cam_points=cut(x.cam_points),
        cam_point_valid=cut(x.cam_point_valid),
        frames=None if x.frames is None else V.VioFrameInput(
            *(f[:nv] for f in x.frames)),
        lidar_times=x.lidar_times[:n],
        sweeps=L.Sweep(*(f[:n] for f in x.sweeps)),
        guess_idx=x.guess_idx[:n])


def to_device(x: DriveInputs, dev, dtype=torch.float32) -> DriveInputs:
    def mv(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev, dtype if v.is_floating_point() else v.dtype)
        if isinstance(v, tuple):
            return type(v)(*map(mv, v)) if hasattr(v, "_fields") \
                else tuple(map(mv, v))
        return v
    return DriveInputs(*map(mv, x))


def _sync_of(dev):
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def stage_seconds(timer: U.StageTimer) -> dict[str, float]:
    """Total seconds per stage of a ``utils.tracing.StageTimer`` (each
    call timed until its outputs' device work is done)."""
    return {k: v["total_s"] for k, v in timer.summary().items()}


@contextlib.contextmanager
def wrapped(*subs):
    """For the block, put ``wrap(fn)`` in place of each ``module.name``
    given as ``(module, name, wrap)``."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in subs]
    for (mod, name, fn), (_, _, wrap) in zip(saved, subs):
        setattr(mod, name, wrap(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def timed(timer: U.StageTimer, name: str):
    """A ``wrapped`` wrap that times each call of the function as stage
    ``name``."""
    return lambda fn: functools.partial(timer.time, name, fn)


def timed_run_vil_stages(timer: U.StageTimer):
    """Time the four stages inside ``run_vil`` by wrapping the functions it
    calls (the VIO run, geometric or photometric, LiDAR odometry, the gate
    and the fusion engine); what is left of its wall is the priors and the
    timeline merge."""
    return wrapped((VIL.V, "run", timed(timer, "vio")),
                   (VIL.PH, "run", timed(timer, "vio")),
                   (VIL.L.odometry, "run", timed(timer, "lidar")),
                   (VIL.DG, "logdet_gate", timed(timer, "gate")),
                   (VIL.E, "run", timed(timer, "fusion")))


def run_path(cfg: VIL.VilConfig, fcfg: F.FrontendConfig, x: DriveInputs,
             timer: U.StageTimer | None = None):
    """The main path once, from fresh states: the image tracker (when the
    inputs hold a camera stream) and then the port's ``run_vil``. Returns
    (VIO frames, VilResult)."""
    dev, dt = x.pose0.device, x.pose0.dtype
    stage = timer.time if timer else (lambda name, fn, *a, **k: fn(*a, **k))
    frames = x.frames
    if frames is None:
        pyrs = stage("pyramids", F.pyramids_batch, fcfg, x.images)
        cand = stage("detect+depth", F.candidates_batch, fcfg, x.images,
                     x.cam_points, x.cam_point_valid)
        frames, _ = stage("track", F.track_frames, fcfg, pyrs, *cand,
                          x.imu_windows, cfg.vio.num_landmarks)
    zeros6 = torch.zeros(6, dtype=dt, device=dev)
    vs = V.init(cfg.vio, x.pose0, x.vel0, zeros6)
    ls = L.odometry.init(cfg.lidar, dt, pose0=x.pose0)
    es = fu.init(cfg.fusion, x.pose0, x.vel0, zeros6,
                 torch.zeros((), dtype=dt, device=dev) - 1e-3)
    ctx = (timed_run_vil_stages(timer) if timer is not None
           else contextlib.nullcontext())
    with ctx:
        _, res = VIL.run_vil(
            cfg, x.imu_times, x.imu_accel, x.imu_gyro,
            x.vio_times, frames, vs, x.lidar_times, x.sweeps, ls,
            lidar_guess_from_vio_idx=x.guess_idx, engine_state=es)
    return frames, res


def ate(poses: np.ndarray, gt: np.ndarray) -> float:
    """Translation RMSE (m); both trajectories start at the true pose."""
    return float(np.sqrt(np.mean(np.sum((poses[:, 4:] - gt[:, 4:]) ** 2,
                                        axis=-1))))


def check_drive(sc, x: DriveInputs, frames, res, launches: list) -> dict:
    """The repo's own checks on one drive: k-NN launches 4 per sweep,
    tracker live share, finite fused poses of the right shape, the gate
    keeps sweeps, and VIO, LiDAR and fused ATE within their bounds."""
    T_l, T_v = len(x.lidar_times), len(x.vio_times)
    fused = res.fused.poses.cpu().numpy()
    keep = res.gate.keep.cpu().numpy()
    gt_fused = torch.func.vmap(sc.traj.pose_fn)(res.timeline.times)
    out = {
        "sweeps": T_l, "vio_frames": T_v, "events": T_l + T_v,
        "launches": launches,
        "live_share": float(frames.obs_valid[2:].mean()),
        "vio_ate_m": ate(res.vio_out.pose.cpu().numpy(),
                         sc.gt_vio_poses[:T_v]),
        "lidar_ate_m": ate(res.lidar_out.pose.cpu().numpy(),
                           sc.gt_lidar_poses[:T_l]),
        "fused_ate_m": ate(fused, gt_fused.cpu().numpy()),
        "keep_share": float(keep.mean()),
        "healthy_share": float(res.fused.healthy.cpu().numpy().mean())}
    check(launches == [4 * T_l] * len(launches),
          f"k-NN kernel launches {launches}, want 4 per sweep ({4 * T_l})")
    check(fused.shape == (T_l + T_v, 7), f"fused poses shape {fused.shape}")
    check(bool(np.isfinite(fused).all()), "non-finite fused pose")
    check(out["live_share"] > 0.5,
          f"tracker live share {out['live_share']} <= 0.5")
    check(out["keep_share"] > 0.0, "the gate kept no sweep")
    check(out["vio_ate_m"] < 0.5, f"VIO ATE {out['vio_ate_m']} m")
    check(out["lidar_ate_m"] < 0.5, f"LiDAR ATE {out['lidar_ate_m']} m")
    check(out["fused_ate_m"] < 1.0, f"fused ATE {out['fused_ate_m']} m")
    return out


@contextlib.contextmanager
def recorded_knn_calls(calls: list):
    """Append a copy of the inputs of every k-NN search the path makes to
    ``calls``, one per lane: on the CPU where the ICP calls
    ``ops.knn.knn``, on a card at the kernel's entry ``knn_cuda_lanes``,
    which every launch goes through (those a replay of a captured step
    makes between its graphs too)."""
    knn, lanes = K.knn, K.knn_cuda_lanes

    def record(q, t, m, k=K.K_DEFAULT):
        if q.device.type != "cuda":
            calls.append((q.clone(), t.clone(), m.clone()))
        return knn(q, t, m, k)

    def record_lanes(q, t, m, *args, **kwargs):
        calls.extend(zip(q.clone(), t.clone(), m.clone()))
        return lanes(q, t, m, *args, **kwargs)
    K.knn, K.knn_cuda_lanes = record, record_lanes
    try:
        yield
    finally:
        K.knn, K.knn_cuda_lanes = knn, lanes


def check_drive_knn(calls: list) -> float:
    """The kernel against knn_torch on the inputs of a drive's k-NN calls
    (queries, masked submaps); one line per shape. Returns the largest
    |Δd²|."""
    by_shape: dict = {}
    for n, (q, t, m) in enumerate(calls):
        _, _, err, tol, sep = compare_knn(f"drive call {n}", q, t, m)
        row = by_shape.setdefault((q.shape[0], t.shape[0]),
                                  [0, 0.0, 0.0, 0, 0])
        row[0] += 1
        row[1] = max(row[1], err)
        row[2] = max(row[2], tol)
        row[3] += int(sep.sum())
        row[4] += sep.numel()
    for (Q, M), (n, err, tol, n_sep, n_slots) in sorted(by_shape.items()):
        print(f"  drive {Q:5d}x{M:<5d} {n:3d} calls ok   max|Δd²| {err:.3g}"
              f"  (tol {tol:.3g})  indices checked at the {n_sep} of "
              f"{n_slots} slots whose neighbours are separated", flush=True)
    return max(r[1] for r in by_shape.values())


def drive_full_path(cfg, fcfg, sc, x: DriveInputs) -> dict:
    """Phase 4: the image-driven path on the card, cold then warm; the warm
    run is split by stage with synchronised timers. The inputs of the cold
    run's k-NN calls are kept for :func:`check_drive_knn`."""
    sync = _sync_of(x.pose0.device)
    walls, launches, timer, calls = [], [], None, []
    torch.cuda.reset_peak_memory_stats()
    for run in ("cold", "warm"):
        timer = U.StageTimer() if run == "warm" else None
        sync()
        K.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        with (recorded_knn_calls(calls) if run == "cold"
              else contextlib.nullcontext()):
            frames, res = run_path(cfg, fcfg, x, timer)
        sync()
        walls.append(time.perf_counter() - t0)
        launches.append(K.KERNEL_LAUNCHES)
    out = check_drive(sc, x, frames, res, launches)
    stages = stage_seconds(timer)
    stages["other"] = walls[1] - sum(stages.values())
    out.update(cold_s=walls[0], warm_s=walls[1],
               events_per_s=out["events"] / walls[1],
               warm_stage_s=stages,
               peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print("  " + json.dumps(out), flush=True)
    return {"numbers": out, "frames": frames, "result": res,
            "knn_calls": calls}


def drive_synthetic_tracks(cfg, fcfg, dev) -> dict:
    """Phase 5: the path on the scenario's synthetic feature tracks (the
    JAX package's default VIO input) over a shorter drive, once."""
    sc, x = make_inputs(cfg, dev, SHORT_DURATION, from_images=False)
    sync = _sync_of(dev)
    sync()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    frames, res = run_path(cfg, fcfg, x)
    sync()
    wall = time.perf_counter() - t0
    out = check_drive(sc, x, frames, res, [K.KERNEL_LAUNCHES])
    out.update(wall_s=wall, events_per_s=out["events"] / wall)
    print("  " + json.dumps(out), flush=True)
    return out


def compare_runs(a, b, n: int) -> dict:
    """Largest differences between two runs (frames, VilResult) of the
    same first ``n`` sweeps: ``a`` may hold more events than ``b``."""
    (fa, ra), (fb, rb) = a, b
    nv = fb.obs_valid.shape[0]
    np_ = lambda t: t.detach().cpu().double().numpy()
    va, vb = np_(ra.vio_out.pose[:nv]), np_(rb.vio_out.pose)
    la, lb = ra.lidar_out, rb.lidar_out
    pa, pb = np_(la.pose[:n]), np_(lb.pose)
    Ha, Hb = np_(la.hessian[:n]), np_(lb.hessian)
    na, nb = np_(la.n_corr[:n]), np_(lb.n_corr)
    Fa, Fb = np_(ra.fused.poses[:n + nv]), np_(rb.fused.poses)
    h_rel = (np.linalg.norm(Ha - Hb, axis=(1, 2))
             / np.maximum(np.linalg.norm(Hb, axis=(1, 2)), 1e-9))
    return {
        "track_valid_mismatch": float(
            (np_(fa.obs_valid[:nv]) != np_(fb.obs_valid)).mean()),
        "vio_trans_err_m": float(np.abs(va[:, 4:] - vb[:, 4:]).max()),
        "vio_quat_err": float(np.abs(va[:, :4] - vb[:, :4]).max()),
        "lidar_trans_err_m": float(np.abs(pa[:, 4:] - pb[:, 4:]).max()),
        "lidar_quat_err": float(np.abs(pa[:, :4] - pb[:, :4]).max()),
        "hessian_rel_err": float(h_rel.max()),
        "n_corr_err": float(np.abs(na - nb).max()),
        "n_corr_rel_err": float((np.abs(na - nb)
                                 / np.maximum(np.abs(nb), 1.0)).max()),
        "fused_trans_err_m": float(np.abs(Fa[:, 4:] - Fb[:, 4:]).max()),
        "fused_quat_err": float(np.abs(Fa[:, :4] - Fb[:, :4]).max())}


# Phase 6 tolerances. The CPU rerun takes the card's own images, sweeps and
# IMU, so what differs is arithmetic: f32 sums in another order (cuBLAS vs
# the CPU's BLAS in KLT's window products, the EKF and the ICP normal
# equations), and the card's and the CPU's sin/cos/sqrt differ in the last
# bit. Each device repeats itself bit for bit. So the bound is the f32 band:
# how far each f32 run lies from a float64 CPU run of the same code and
# inputs, the two f32 runs possibly on opposite sides of it. Measured on
# the first 10 sweeps and 20 frames of this drive (H100 80GB HBM3, 700 W):
# card / CPU f32 against f64 differ by 0 / 0 tracker validities, VIO
# 3.3e-6 / 2.6e-6 m, LiDAR 2.5 / 7.1 mm and 1.3e-4 / 4.9e-4 in the
# quaternion, Hessians 3.6% / 9.6% (Frobenius), n_corr 1.5% / 2.6%, fused
# 0.11 / 0.23 mm. The tolerances cover the sum of the two bands with
# room: a flipped line/plane gate or KLT check moves the chain further.
# The VIO's is tight (a flipped track would show), the fused poses' follows
# the LiDAR's, which drives them.
CROSS_TOL = {
    "track_valid_mismatch": 0.02,
    "vio_trans_err_m": 1e-3, "vio_quat_err": 1e-4,
    "lidar_trans_err_m": 2e-2, "lidar_quat_err": 2e-3,
    "hessian_rel_err": 0.2, "n_corr_rel_err": 0.06,
    "fused_trans_err_m": 2e-2, "fused_quat_err": 2e-3,
}


def cross_check(cfg, fcfg, x: DriveInputs, dev_run,
                n: int = CROSS_SWEEPS) -> dict:
    """Phase 6: rerun the first ``n`` sweeps and their frames on the CPU
    from the card's images and compare with the card's run; both the
    tracker and ``run_vil`` are causal, so those events are the same
    computation."""
    xc = to_device(first_events(x, n), torch.device("cpu"))
    K.KERNEL_LAUNCHES = 0
    cpu_run = run_path(cfg, fcfg, xc)
    check(K.KERNEL_LAUNCHES == 0, "the CPU rerun launched the CUDA kernel")
    out = compare_runs(dev_run, cpu_run, n)
    out.update(sweeps=n, frames=len(xc.vio_times))
    print("  " + json.dumps(out), flush=True)
    for key, tol in CROSS_TOL.items():
        check(out[key] <= tol, f"cross-check {key} {out[key]} > {tol}")
    return out


# --------------------------------------------------------------------------
# Phase 7: degeneracy experiments
# --------------------------------------------------------------------------

def scenario_head(sc, n: int, dev):
    """The first ``n`` sweeps of a scenario and its VIO frames up to the
    last of them, on ``dev`` (the IMU stream whole: the engine reads it up
    to the last event)."""
    nv = int(np.searchsorted(sc.vio_times, sc.lidar_times[n - 1] + 1e-9))
    mv = lambda v: v.to(dev)
    return sc._replace(
        world=type(sc.world)(*map(mv, sc.world)),
        imu_times=mv(sc.imu_times), imu_accel=mv(sc.imu_accel),
        imu_gyro=mv(sc.imu_gyro), vio_times=sc.vio_times[:nv],
        vio_frames=V.VioFrameInput(*(mv(f[:nv]) for f in sc.vio_frames)),
        lidar_times=sc.lidar_times[:n],
        sweeps=L.Sweep(*(mv(f[:n]) for f in sc.sweeps)),
        lidar_guess_idx=sc.lidar_guess_idx[:n],
        gt_vio_poses=sc.gt_vio_poses[:nv], gt_lidar_poses=sc.gt_lidar_poses[:n])


def run_cell(spec, dev, calls: list | None = None):
    """One experiment cell as ``eval.experiments._run`` composes it, with
    the scenario built on ``dev`` (timed apart) and the run timed to its
    numpy results, split by ``run_vil``'s stages (``scoring+other``: the
    priors, the timeline merge, the scores and the numpy results). Counts
    the kernel's launches; with ``calls`` keeps the inputs of every k-NN
    call. Returns (config, scenario, result dict, printed numbers)."""
    sync = _sync_of(dev)
    cfg = EX.experiment_config(spec)
    sync()
    t0 = time.perf_counter()
    sc = EX.experiment_scenario(spec, cfg, dev)
    sync()
    build_s = time.perf_counter() - t0
    timer = U.StageTimer()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with timed_run_vil_stages(timer), (
            recorded_knn_calls(calls) if calls is not None
            else contextlib.nullcontext()):
        out = EX.run_scenario(spec, cfg, sc)
    sync()
    wall = time.perf_counter() - t0
    stages = stage_seconds(timer)
    stages["scoring+other"] = wall - sum(stages.values())
    nums = {"kind": spec.kind, "sweeps": len(out["lidar_times"]),
            "events": out["events"], "scenario_s": build_s, "wall_s": wall,
            "events_per_s": out["events"] / wall, "stage_s": stages,
            "launches": K.KERNEL_LAUNCHES,
            "ate_fused_m": out["ate_fused"], "ate_vio_m": out["ate_vio"],
            "ate_lidar_m": out["ate_lidar"],
            "keep_share": out["gate_keep_fraction"],
            "median_n_corr": float(np.median(out["n_corr"]))}
    print("  " + json.dumps(nums), flush=True)
    check(bool(np.isfinite(out["fused_poses"]).all()),
          f"{spec.kind}: non-finite fused pose")
    check(out["ate_fused"] < 1.0, f"{spec.kind}: fused ATE "
          f"{out['ate_fused']} m")
    return cfg, sc, out, nums


def pooled_numbers(results: list) -> dict:
    """The pooled AUC table (every score against its typed labels, as
    ``aggregate_report`` computes it without the figures), the calibrated
    gate thresholds and the raw-threshold parity."""
    pooled, lab_trans, lab_rot = EX._pool_scores(results)
    aucs = {}
    for name, s in pooled.items():
        lab = lab_rot if EX._is_rot_metric(name) else lab_trans
        if lab.any() and not lab.all():
            aucs[name] = float(R.roc(
                torch.as_tensor(lab), torch.as_tensor(s),
                low_is_degenerate=EX._low_is_degenerate(name)).auc)
    thresholds = EX.calibrate_thresholds(results)
    return {"auc": aucs, "calibrated_thresholds": thresholds,
            "raw_threshold_parity": EX.raw_threshold_parity(results,
                                                            thresholds)}


def compare_experiment(a: dict, b: dict, n: int) -> dict:
    """Largest differences between two result dicts over their first ``n``
    sweeps and the VIO frames up to the last of them: poses, Hessians and
    n_corr, the count of score entries whose NaN / +inf / -inf class
    differs, and per score series max |Δ| / max(|b|, 1) over its finite
    entries."""
    nv = int(np.searchsorted(b["vio_times"], b["lidar_times"][n - 1] + 1e-9))
    cut = lambda r, key, m: np.asarray(r[key][:m], np.float64)
    va, vb = cut(a, "vio_poses", nv), cut(b, "vio_poses", nv)
    la, lb = cut(a, "lidar_poses", n), cut(b, "lidar_poses", n)
    fa, fb = cut(a, "fused_poses", n + nv), cut(b, "fused_poses", n + nv)
    Ha, Hb = cut(a, "hessian", n), cut(b, "hessian", n)
    na, nb = cut(a, "n_corr", n), cut(b, "n_corr", n)
    out = {
        "vio_trans_err_m": np.abs(va[:, 4:] - vb[:, 4:]).max(),
        "vio_quat_err": np.abs(va[:, :4] - vb[:, :4]).max(),
        "lidar_trans_err_m": np.abs(la[:, 4:] - lb[:, 4:]).max(),
        "lidar_quat_err": np.abs(la[:, :4] - lb[:, :4]).max(),
        "hessian_rel_err": (np.linalg.norm(Ha - Hb, axis=(1, 2)) / np.maximum(
            np.linalg.norm(Hb, axis=(1, 2)), 1e-9)).max(),
        "n_corr_rel_err": (np.abs(na - nb) / np.maximum(np.abs(nb), 1)).max(),
        "fused_trans_err_m": np.abs(fa[:, 4:] - fb[:, 4:]).max(),
        "fused_quat_err": np.abs(fa[:, :4] - fb[:, :4]).max()}
    out = {k: float(v) for k, v in out.items()}
    mismatch, score_err = 0, {}
    for name in b["scores"]:
        sa, sb = cut(a["scores"], name, n), cut(b["scores"], name, n)
        for cls in (np.isnan, np.isposinf, np.isneginf):
            mismatch += int((cls(sa) != cls(sb)).sum())
        fin = np.isfinite(sa) & np.isfinite(sb)
        score_err[name] = float((np.abs(sa[fin] - sb[fin]) / np.maximum(
            np.abs(sb[fin]), 1.0)).max()) if fin.any() else 0.0
    out["score_class_mismatches"] = mismatch
    out["score_rel_err"] = score_err
    return out


# Phase 7 CPU rerun tolerances: the corridor's first 5 sweeps and 10
# frames from the card's own scenario. The corridor leaves x unobservable,
# so its f32 runs wander further from a float64 run than the town's do.
# Measured with tools/cross_band.py on the 1.2 s cell (H100 80GB HBM3,
# 700 W), card / CPU f32 against a float64 CPU run: LiDAR 2.5 / 2.0 cm and
# 9.5e-4 / 9.6e-4 in the quaternion, Hessians 39% / 10% (Frobenius),
# n_corr 4.0% / 4.4%, VIO 2.7e-6 / 2.9e-6 m, fused 1.6e-7 m; scores, max
# |Δ| / max(|score|, 1) per series, up to 0.41 / 0.12; card against CPU
# f32 directly: Hessians 38%, a score 0.38. Each device repeats itself bit
# for bit and the NaN / inf pattern of every score was identical, so that
# pattern is held exactly and the rest to 1.6-4.5 times the two bands
# together. The VIO and fused tolerances stay phase 6's.
EXP_CROSS_TOL = {
    "vio_trans_err_m": CROSS_TOL["vio_trans_err_m"],
    "vio_quat_err": CROSS_TOL["vio_quat_err"],
    "lidar_trans_err_m": 0.2, "lidar_quat_err": 4e-3,
    "hessian_rel_err": 0.8, "n_corr_rel_err": 0.3,
    "fused_trans_err_m": CROSS_TOL["fused_trans_err_m"],
    "fused_quat_err": CROSS_TOL["fused_quat_err"],
}
SCORE_TOL = 1.0


def drive_experiments(dev, cache_dir: str) -> dict:
    """Phase 7: the smoke grid's four cells on the card, the kernel against
    knn_torch on every k-NN call of the corridor cell, the corridor's dist
    slopes, the pooled report, and the CPU rerun of the corridor's head
    (which also gives the k-NN calls per sweep every cell must launch).
    The cells that phase 14's grid shares (the tunnel) are written into
    ``cache_dir`` as ``run_experiment`` caches them."""
    specs = EX.smoke_grid(seeds=(0,), duration=EXPERIMENT_DURATION)
    shared = {s.key() for s in EX.default_grid(seeds=(0,),
                                               duration=GRID_DURATION)}
    results, cells, corridor, calls = [], {}, None, []
    for spec in specs:
        keep = calls if spec.kind == "corridor" else None
        cfg, sc, out, nums = run_cell(spec, dev, keep)
        results.append(out)
        cells[spec.kind] = nums
        if spec.key() in shared:
            EX.save_result(out, EX.cache_path(spec, cache_dir))
        if spec.kind == "corridor":
            corridor = (spec, cfg, sc, out)

    print(f"[kernel vs plain on the corridor cell] its {len(calls)} k-NN "
          f"calls", flush=True)
    max_err = check_drive_knn(calls)
    T = cells["corridor"]["sweeps"]
    per_sweep = {}
    for q, t, _ in calls:
        key = f"{q.shape[0]}x{t.shape[0]}"
        per_sweep[key] = per_sweep.get(key, 0) + 1
    per_sweep = {k: v / T for k, v in per_sweep.items()}
    known = {f"{Q}x{M}" for Q, M in MAIN_PATH_SHAPES[:2] + EXPERIMENT_SHAPES}
    check(set(per_sweep) == known,
          f"experiment k-NN shapes {sorted(per_sweep)}, want {sorted(known)}")
    calls.clear()

    spec, cfg, sc, out = corridor
    sl = {a: out["scores"][f"dist_slope_{a}"][1:] for a in ("tx", "ty", "tz")}
    tx = float(np.median(sl["tx"]))
    cross = float(np.median(np.maximum(sl["ty"], sl["tz"])))
    print(f"  corridor dist slopes: median tx {tx:.4g}, median max(ty, tz) "
          f"{cross:.4g}", flush=True)
    check(tx < 0.1 * cross, f"corridor dist_slope_tx {tx} >= 0.1 x {cross}")

    pooled = pooled_numbers(results)
    _, lab_trans, lab_rot = EX._pool_scores(results)
    for kind, lab in (("translation", lab_trans), ("rotation", lab_rot)):
        check(bool(lab.any()) and not bool(lab.all()),
              f"the pooled {kind} labels have one class only")
    print("  pooled AUC " + json.dumps(pooled["auc"], sort_keys=True),
          flush=True)
    print("  calibrated thresholds "
          + json.dumps(pooled["calibrated_thresholds"]), flush=True)
    print("  raw-threshold parity "
          + json.dumps(pooled["raw_threshold_parity"]), flush=True)

    n = CROSS_EXP_SWEEPS
    print(f"[experiment cross-check] corridor's first {n} sweeps on the CPU",
          flush=True)
    diff, cpu_per_sweep = rerun_cell_cpu(spec, cfg, sc, out, n)
    for kind, nums in cells.items():
        want = cpu_per_sweep * nums["sweeps"]
        check(nums["launches"] == want, f"{kind}: {nums['launches']} k-NN "
              f"launches, want {cpu_per_sweep} per sweep ({want})")
    check_cross_experiment(diff)
    return {"cells": cells, "pooled": pooled, "cross": diff,
            "knn_calls_per_sweep": per_sweep, "max_err": max_err}


def rerun_cell_cpu(spec, cfg, sc, out: dict, n: int) -> tuple[dict, int]:
    """A cell's first ``n`` sweeps (and their VIO frames) again on the CPU
    in float32 from the card's own scenario ``sc``; prints and returns
    ``compare_experiment`` of the card's result ``out`` against it, and the
    CPU's k-NN calls per sweep."""
    cpu_calls = []
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with recorded_knn_calls(cpu_calls):
        cpu_out = EX.run_scenario(spec, cfg,
                                  scenario_head(sc, n, torch.device("cpu")))
    cpu_s = time.perf_counter() - t0
    check(K.KERNEL_LAUNCHES == 0, "the CPU rerun launched the CUDA kernel")
    check(len(cpu_calls) % n == 0, f"{len(cpu_calls)} CPU k-NN calls over "
          f"{n} sweeps")
    diff = compare_experiment(out, cpu_out, n)
    diff["cpu_s"] = cpu_s
    print("  " + json.dumps(diff), flush=True)
    return diff, len(cpu_calls) // n


def check_cross_experiment(diff: dict) -> None:
    """A CPU rerun against the card within ``EXP_CROSS_TOL`` and
    ``SCORE_TOL``, with the same NaN / ±inf pattern in every score."""
    check(diff["score_class_mismatches"] == 0,
          "the CPU rerun's scores have another NaN / inf pattern")
    for key, tol in EXP_CROSS_TOL.items():
        check(diff[key] <= tol, f"experiment cross-check {key} {diff[key]} "
              f"> {tol}")
    worst = max(diff["score_rel_err"], key=diff["score_rel_err"].get)
    check(diff["score_rel_err"][worst] <= SCORE_TOL,
          f"experiment cross-check score {worst} "
          f"{diff['score_rel_err'][worst]} > {SCORE_TOL}")


# --------------------------------------------------------------------------
# Phase 8: raw-sensor bag replay through the CLI at the reference rig
# --------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
FULL_CONFIG = REPO / "configs" / "carla_full.yaml"
BAG_DURATION = 1.0      # s of the recorded town drive: 10 sweeps, 20 frames
BAG_CPU_SWEEPS = 2      # sweeps of the CPU run that counts k-NN calls
# Cells of the ingested sweeps whose mask or xyz may differ between the
# card's organize and the CPU's on the same bag: a point on a ring or
# azimuth edge, or two nearly equidistant points of one cell, can move
# with an ulp of atan2 / sqrt. The recorded rays lie at bin centres: on
# the H100 80GB HBM3 (700 W), 0 of the 288,000 cells of the 10 sweeps
# differed (ranges within 1.19e-7 relative), so none may.
BAG_EDGE_CELLS = 0


def record_bag(path: Path, dev, duration: float = BAG_DURATION) -> dict:
    """Render a ``duration`` s town drive at ``configs/carla_full.yaml``'s
    rig on ``dev`` (800×600 camera, full VLP-16 sweeps; untimed) and write
    it as a bz2 raw-sensor bag with ``scenarios.write_scenario_bag`` (what
    ``cli record`` writes, at the full rig). Returns the bag's bytes and
    message counts."""
    cfg = C.load(str(FULL_CONFIG)).vil()
    sync = _sync_of(dev)
    t0 = time.perf_counter()
    sc = scenarios.build("town", duration=duration, vio_cfg=cfg.vio,
                         dtype=torch.float32, device=dev)
    images, _, _ = scenarios.render_frontend_inputs(sc, cfg.vio.cam,
                                                    cfg.vio.pose_ic)
    sync()
    t1 = time.perf_counter()
    scenarios.write_scenario_bag(path, sc._replace(images=images),
                                 compression="bz2")
    t2 = time.perf_counter()
    with BagReader(path) as bag:
        counts = {topic: bag.count(topic) for topic in sorted(bag.topics())}
    out = {"bytes": path.stat().st_size, "messages": counts,
           "render_s": t1 - t0, "write_s": t2 - t1,
           "images": list(images.shape)}
    print("  " + json.dumps(out), flush=True)
    return out


def run_cli_bag(path: Path, ckpt: Path, dev, calls: list | None = None,
                config: Path = FULL_CONFIG) -> dict:
    """``cli.main(["run", "--bag", ..., "--config", config, "--checkpoint",
    ..., "--device", dev])``, as a user runs it, timed by stage (ingest with
    organize inside it, the tracker or, in photometric mode, the batched
    front-end, and run_vil's four stages); with ``calls``, the inputs of
    every k-NN call are kept. Returns the CLI's JSON, the wall, the stage
    seconds, the kernel's launches and what ``run_vil_from_bag``
    returned."""
    timer = U.StageTimer()
    kept = {}

    def keep(fn):
        def run(*a, **k):
            kept["es"], kept["res"], kept["ba"] = out = fn(*a, **k)
            return out
        return run
    stdout = io.StringIO()
    argv = ["run", "--bag", str(path), "--config", str(config),
            "--checkpoint", str(ckpt), "--device", str(dev)]
    sync = _sync_of(dev)
    sync()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with wrapped((VIL, "run_vil_from_bag", keep),
                 (IG, "load_bag", timed(timer, "ingest")),
                 (IG.RI, "organize", timed(timer, "organize")),
                 (VIL, "build_vio_frames_from_bag", timed(timer, "tracker")),
                 (VIL, "build_photo_inputs_from_bag",
                  timed(timer, "frontend")),
                 (VIL, "run_vil", timed(timer, "run_vil"))), \
            timed_run_vil_stages(timer), \
            (recorded_knn_calls(calls) if calls is not None
             else contextlib.nullcontext()), \
            contextlib.redirect_stdout(stdout):
        cli.main(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = K.KERNEL_LAUNCHES
    text = stdout.getvalue()
    return {"json": json.loads(text[text.index("{"):]), "wall_s": wall,
            "stage_s": stage_seconds(timer), "launches": launches, **kept}


def compare_ingest(ba_dev: IG.BagArrays, ba_cpu: IG.BagArrays) -> dict:
    """The card's ingested sweeps against the CPU's from the same file:
    cells whose mask or xyz differ, and the largest relative range
    difference where both are set."""
    a = [t.cpu() for t in ba_dev.sweeps]
    b = list(ba_cpu.sweeps)
    differ = (a[2] != b[2]) | (a[0] != b[0]).any(-1)
    both = (a[2] > 0) & (b[2] > 0)
    rel = ((a[1] - b[1]).abs() / b[1].clamp(min=1e-6))[both]
    host = all(np.array_equal(getattr(ba_dev, f), getattr(ba_cpu, f))
               for f in ("imu_times", "imu_accel", "lidar_times",
                         "cam_times", "images", "gt_poses"))
    return {"cells": differ.numel(), "cells_differ": int(differ.sum()),
            "valid_cells": int((b[2] > 0).sum()),
            "max_rng_rel_err": float(rel.max()) if rel.numel() else 0.0,
            "host_streams_equal": host}


def knn_calls_per_sweep_cpu(lidar_cfg: L.LidarOdomConfig, sweeps: L.Sweep,
                            n: int = BAG_CPU_SWEEPS) -> int:
    """k-NN calls per sweep of the CPU's LiDAR odometry over the first ``n``
    of ``sweeps`` (moved to the CPU) at ``lidar_cfg`` (the count does not
    depend on the priors)."""
    cpu = torch.device("cpu")
    calls = []
    K.KERNEL_LAUNCHES = 0
    with recorded_knn_calls(calls):
        L.odometry.run(lidar_cfg, L.odometry.init(
            lidar_cfg, torch.float32, pose0=lie.pose_identity(device=cpu)),
            L.Sweep(*(f[:n].to(cpu) for f in sweeps)),
            lie.pose_identity(device=cpu).expand(n, 7))
    check(K.KERNEL_LAUNCHES == 0, "the CPU run launched the CUDA kernel")
    check(len(calls) % n == 0, f"{len(calls)} CPU k-NN calls over {n} sweeps")
    return len(calls) // n


def replay_bag(dev, tmp: Path, duration: float = BAG_DURATION) -> dict:
    """Phase 8: record the bag into ``tmp`` (where phase 10 replays it
    again), replay it through the CLI on the card, and check the run: the
    CLI's outputs, the k-NN launches against a CPU run's count, the kernel
    against knn_torch on every k-NN call of the run, the checkpoint against
    the final engine state, and the card's ingestion against the CPU's."""
    cfg = C.load(str(FULL_CONFIG)).vil()
    bag, ckpt = tmp / "town_full.bag", tmp / "engine.npz"
    recorded = record_bag(bag, dev, duration)
    calls = []
    run = run_cli_bag(bag, ckpt, dev, calls)
    res, es, ba = run["res"], run["es"], run["ba"]
    T = len(ba.lidar_times)
    events = run["json"]["events"]
    st = run["stage_s"]
    nums = {
        "cli": run["json"], "wall_s": run["wall_s"], "stage_s": st,
        "events_per_s": events / run["wall_s"],
        "tracker_run_vil_s": st["tracker"] + st["run_vil"],
        "events_per_s_tracker_run_vil": events / (st["tracker"]
                                                  + st["run_vil"]),
        "launches": run["launches"], "sweeps": T,
        "frames": len(ba.cam_times)}
    per_sweep = {}
    for q, t, _ in calls:
        key = f"{q.shape[0]}x{t.shape[0]}"
        per_sweep[key] = per_sweep.get(key, 0) + 1
    nums["knn_calls_per_sweep"] = {k: v / T for k, v in per_sweep.items()}
    print("  " + json.dumps(nums), flush=True)
    out = run["json"]
    fused = res.fused.poses.cpu().numpy()
    want_T = round(duration * 10)
    check(fused.shape == (events, 7) and T == want_T
          and events == 3 * want_T,
          f"bag replay: {T} sweeps, {events} events, fused {fused.shape}")
    check(bool(np.isfinite(fused).all()), "bag replay: non-finite pose")
    check(out["healthy_fraction"] == 1.0,
          f"bag replay healthy share {out['healthy_fraction']}")
    check(out["fused_ate_rmse_m"] < 1.0,
          f"bag replay fused ATE {out['fused_ate_rmse_m']} m")
    check(out["gate_keep_fraction"] > 0.5,
          f"bag replay gate keep share {out['gate_keep_fraction']}")

    print(f"[kernel vs plain on the bag replay] its {len(calls)} k-NN "
          f"calls", flush=True)
    max_err = check_drive_knn(calls)
    calls.clear()

    template = fu.init(cfg.fusion, lie.pose_identity(device=dev),
                       torch.zeros(3, device=dev),
                       torch.zeros(6, device=dev),
                       torch.zeros((), device=dev))
    back = U.restore(str(ckpt), template)
    leaves = list(zip(_tree.tree_leaves(es), _tree.tree_leaves(back)))
    check(type(back) is type(es) and all(
        b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)
        for a, b in leaves),
        "the checkpoint does not restore the final engine state")
    print(f"  checkpoint: {len(leaves)} leaves restored into a fresh "
          f"fusion.init template, equal bit for bit", flush=True)

    t0 = time.perf_counter()
    ba_cpu = IG.load_bag(bag, gt_topic="/gt/odometry",
                         device=torch.device("cpu"))
    ingest = compare_ingest(ba, ba_cpu)
    ingest["cpu_ingest_s"] = time.perf_counter() - t0
    cpu_per_sweep = knn_calls_per_sweep_cpu(cfg.lidar, ba_cpu.sweeps)
    ingest["cpu_knn_calls_per_sweep"] = cpu_per_sweep
    print("  ingest, card vs CPU: " + json.dumps(ingest), flush=True)
    check(ingest["host_streams_equal"],
          "the card's and the CPU's ingestion differ on a host stream")
    check(ingest["cells_differ"] <= BAG_EDGE_CELLS,
          f"{ingest['cells_differ']} sweep cells differ between the "
          f"card's and the CPU's ingestion (> {BAG_EDGE_CELLS})")
    check(ingest["max_rng_rel_err"] <= 1.2e-7,
          f"ingested ranges differ by {ingest['max_rng_rel_err']}")
    check(run["launches"] == cpu_per_sweep * T,
          f"bag replay: {run['launches']} k-NN launches, want "
          f"{cpu_per_sweep} per sweep ({cpu_per_sweep * T})")
    return {"numbers": nums, "recorded": recorded, "ingest": ingest,
            "max_err": max_err, "bag": bag,
            "cpu_knn_calls_per_sweep": cpu_per_sweep}


# --------------------------------------------------------------------------
# Phase 9: lanes and collectives
# --------------------------------------------------------------------------

LANES = 8               # the bench's BATCH (bench.py:64)
LANE_EVENTS = 18        # phase 4's first events, run as LANES lanes
LANE_SIGMA = (0.02, 0.005)   # m, rad: lanes 1-7's odometry perturbation
CHAIN_N = 32            # the window-axis chain (tests/test_windows_sharding)


class LaneSource(NamedTuple):
    """What phase 9 takes from phase 4's cold run on the card."""

    timeline: fu.Timeline       # its first LANE_EVENTS events
    fused: fu.FusedOutput       # the same events' fused outputs
    imu: tuple                  # (times, accel, gyro)
    pose0: torch.Tensor
    vel0: torch.Tensor
    sweeps: L.Sweep             # its first two sweeps
    guesses: torch.Tensor       # their LiDAR priors (relative, from the VIO)


def lane_source(x: DriveInputs, res, n: int = LANE_EVENTS) -> LaneSource:
    vio_sel = res.vio_out.pose[torch.as_tensor(x.guess_idx[:2],
                                               device=x.pose0.device)]
    prev = torch.cat([x.pose0[None], vio_sel[:-1]], dim=0)
    return LaneSource(
        timeline=fu.Timeline(*(f[:n] for f in res.timeline)),
        fused=fu.FusedOutput(*(f[:n] for f in res.fused)),
        imu=(x.imu_times, x.imu_accel, x.imu_gyro), pose0=x.pose0,
        vel0=x.vel0, sweeps=L.Sweep(*(f[:2] for f in x.sweeps)),
        guesses=lie.pose_between(prev, vio_sel))


def make_lanes(cfg: VIL.VilConfig, src: LaneSource, B: int = LANES,
               seed: int = 9):
    """B lanes of phase 4's first events: lane 0 as it ran; lanes 1.. with
    seeded perturbations of the odometry poses and each a different LiDAR
    keep mask (one sweep dropped). The LiDAR source does not solve at this
    config (``optimize_after_odom`` false), so the odd lanes also drop one
    VIO frame each: there the other lanes solve and that lane does not
    (a masked solve). Returns the lanes' (states, timelines, imu_t, imu_a,
    imu_g)."""
    tl = src.timeline
    dev, dt = src.pose0.device, src.pose0.dtype
    n = tl.times.shape[0]
    g = torch.Generator().manual_seed(seed)
    source = tl.source.cpu().numpy()
    lid_ev, vio_ev = np.nonzero(source == 1)[0], np.nonzero(source == 0)[0]
    keep = tl.keep.expand(B, n).clone()
    odo = tl.odo_pose.expand(B, n, 7).clone()
    for b in range(1, B):
        xi = torch.cat([LANE_SIGMA[0] * torch.randn(n, 3, generator=g),
                        LANE_SIGMA[1] * torch.randn(n, 3, generator=g)], 1)
        odo[b] = lie.pose_retract(odo[b], xi.to(dev, dt))
        keep[b, int(lid_ev[(b - 1) % len(lid_ev)])] = 0.0
        if b % 2:
            keep[b, int(vio_ev[(2 + b) % len(vio_ev)])] = 0.0
    lanes = lambda v: v.expand((B,) + v.shape).clone()
    tl_b = fu.Timeline(*(lanes(f) for f in tl))._replace(keep=keep,
                                                         odo_pose=odo)
    zeros6 = torch.zeros(6, dtype=dt, device=dev)
    es = fu.init(cfg.fusion, src.pose0, src.vel0, zeros6,
                 torch.zeros((), dtype=dt, device=dev) - 1e-3)
    return (_tree.tree_map(lanes, es), tl_b, *(lanes(v) for v in src.imu))


def lane_err(a: fu.FusedOutput, b: fu.FusedOutput) -> dict:
    pa, pb = a.poses.double().cpu().numpy(), b.poses.double().cpu().numpy()
    return {"fused_trans_err_m": float(np.abs(pa[:, 4:] - pb[:, 4:]).max()),
            "fused_quat_err": float(np.abs(pa[:, :4] - pb[:, :4]).max())}


def drive_lanes(cfg: VIL.VilConfig, src: LaneSource, mesh,
                B: int = LANES) -> dict:
    """8 lanes through ``parallel.batched_fusion_run`` on the mesh's data
    axis, once; lane 0 against phase 4's outputs, the last lane against a
    single-lane ``fusion.run`` of it."""
    lanes = make_lanes(cfg, src, B)
    n = src.timeline.times.shape[0]
    sync = _sync_of(src.pose0.device)
    run = POPS.batched_fusion_run(mesh, cfg.fusion)
    sync()
    t0 = time.perf_counter()
    _, out = run(*lanes)
    sync()
    wall_b = time.perf_counter() - t0
    last = _tree.tree_map(lambda v: v[B - 1], lanes)
    sync()
    t0 = time.perf_counter()
    _, out_1 = fu.run(cfg.fusion, *last)
    sync()
    wall_1 = time.perf_counter() - t0
    solved = out.solved.cpu().numpy() > 0.5
    lane_of = lambda b: fu.FusedOutput(*(f[b] for f in out))
    nums = {"lanes": B, "events": n,
            "lane_events_per_s": B * n / wall_b, "lane_wall_s": wall_b,
            "single_events_per_s": n / wall_1, "single_wall_s": wall_1,
            "lane_over_single_wall_per_event": wall_b / wall_1,
            "masked_solve_events": int((solved.any(0)
                                        & ~solved.all(0)).sum()),
            "lane0_vs_phase4": lane_err(lane_of(0), src.fused),
            "last_lane_vs_single": lane_err(lane_of(B - 1), out_1)}
    check(tuple(out.poses.shape) == (B, n, 7),
          f"lane poses shape {tuple(out.poses.shape)}")
    check(bool(torch.isfinite(out.poses).all()), "non-finite lane pose")
    check(nums["masked_solve_events"] > 0, "no event solved in some lanes "
          "and not in others")
    for key in ("lane0_vs_phase4", "last_lane_vs_single"):
        for k, v in nums[key].items():
            check(v <= CROSS_TOL[k], f"{key} {k} {v} > {CROSS_TOL[k]}")
    return nums


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_tree.tree_leaves(a),
                                                  _tree.tree_leaves(b))
               if isinstance(x, torch.Tensor))


def drive_sharded_lidar(cfg: VIL.VilConfig, src: LaneSource, mesh,
                        calls: list) -> dict:
    """``parallel.make_sharded_lidar_step`` on phase 4's first two sweeps
    over the mesh's model axis (the first seeds the map), its k-NN calls
    recorded; then the unsharded ``odometry.step`` on the same sweeps,
    which it must equal bit for bit at a model axis of size 1."""
    dt = src.pose0.dtype
    step = POPS.make_sharded_lidar_step(mesh, cfg.lidar)
    sweeps = [L.Sweep(*(f[i] for f in src.sweeps)) for i in range(2)]
    K.KERNEL_LAUNCHES = 0
    st = L.odometry.init(cfg.lidar, dt, pose0=src.pose0)
    sharded = []
    with recorded_knn_calls(calls):
        for sw, g in zip(sweeps, src.guesses):
            st, res = step(st, sw, g)
            sharded.append((st, res))
    launches = K.KERNEL_LAUNCHES
    st = L.odometry.init(cfg.lidar, dt, pose0=src.pose0)
    plain = []
    for sw, g in zip(sweeps, src.guesses):
        st, res = L.odometry.step(cfg.lidar, st, sw, g)
        plain.append((st, res))
    equal = _leaves_equal(sharded, plain)
    nums = {"model_axis": mesh.size(PM.MODEL_AXIS), "sweeps": 2,
            "launches": launches, "bit_equal_to_unsharded": equal,
            "n_corr": float(sharded[1][1].n_corr)}
    check(equal, "the size-1 sharded LiDAR step differs from odometry.step")
    check(launches > 0, "the sharded LiDAR step launched no k-NN kernel")
    return nums


def chain_problem(dev, seed: int = 0):
    """tests/test_windows_sharding.py's chain: a smooth trajectory, noisy
    odometry between its CHAIN_N states, noisy initial estimates (f32)."""
    rng = np.random.default_rng(seed)
    ts = np.arange(CHAIN_N) * 0.1
    q = lie.so3_exp_quat(torch.as_tensor(
        np.stack([0.02 * ts, 0.01 * np.sin(ts), 0.3 * ts], -1)))
    p = torch.as_tensor(np.stack([2.0 * ts, np.sin(0.5 * ts), 0.1 * ts], -1))
    gt = torch.cat([q, p], -1)
    meas = lie.pose_retract(lie.pose_between(gt[:-1], gt[1:]),
                            torch.as_tensor(rng.normal(0, 0.01,
                                                       (CHAIN_N - 1, 6))))
    x0 = lie.pose_retract(gt, torch.as_tensor(rng.normal(0, 0.05,
                                                         (CHAIN_N, 6))))
    infos = torch.eye(6, dtype=torch.float64).expand(CHAIN_N - 1, 6, 6) * 100
    return tuple(v.to(dev, torch.float32) for v in
                 (x0, meas, infos, gt[0], torch.eye(6, dtype=torch.float64)
                  * 1e4))


def drive_windows(mesh, dev) -> dict:
    """``windows.solve_sharded`` over the mesh's data axis against
    ``solve_sequential``, on the card; the tolerance of
    tests/test_windows_sharding.py."""
    args = chain_problem(dev)
    seq = PW.solve_sequential(*args, iters=5)
    shd = PW.solve_sharded(mesh, PM.DATA_AXIS, *args, iters=5)
    d_pos = float((shd[:, 4:] - seq[:, 4:]).abs().max())
    dots = float((shd[:, :4] * seq[:, :4]).sum(-1).abs().min())
    nums = {"windows": mesh.size(PM.DATA_AXIS), "states": CHAIN_N,
            "max_pos_err_m": d_pos, "min_quat_dot": dots}
    check(bool(torch.isfinite(shd).all()), "non-finite window solution")
    check(d_pos <= 2e-3, f"window solve positions differ by {d_pos} m")
    check(dots > 1.0 - 1e-5, f"window solve quaternion dot {dots}")
    return nums


def drive_lanes_and_collectives(cfg: VIL.VilConfig, src: LaneSource,
                                dev) -> dict:
    """Phase 9 on a one-rank mesh of the card (NCCL; gloo for the CPU):
    the data axis (lanes), the model axis (sharded LiDAR step, whose k-NN
    calls are returned for the kernel check) and the window axis."""
    t0 = time.perf_counter()
    mesh = PM.make_mesh(n_data=1, n_model=1, devices=dev)
    calls: list = []
    nums = {"backend": dist.get_backend(),
            "lanes": drive_lanes(cfg, src, mesh),
            "model": drive_sharded_lidar(cfg, src, mesh, calls),
            "windows": drive_windows(mesh, dev)}
    nums["wall_s"] = time.perf_counter() - t0
    print("  " + json.dumps(nums), flush=True)
    return {"numbers": nums, "knn_calls": calls}


# --------------------------------------------------------------------------
# Phase 10: the photometric bag replay and the full-batch oracle
# --------------------------------------------------------------------------

PHOTO_CPU_FRAMES = 5    # frames of the photometric VIO rerun on the CPU
# Phase 10 CPU rerun tolerances: the first 5 frames of the photometric VIO
# stage from the card's own inputs. Measured with tools/cross_band.py
# --photometric (H100 80GB HBM3, 700 W), card / CPU f32 against a float64
# CPU run over these 5 frames: VIO 2.2e-5 / 3.5e-5 m and 4.1e-6 / 5.5e-6 in
# the quaternion, covariances 9.4e-5 / 1.1e-4 (Frobenius, relative); card
# against CPU f32 directly 2.2e-5 m, 4.5e-6, 1.3e-4. The card repeated
# itself bit for bit, and the χ² verdicts and live slots of all 24 slots
# were identical on the three runs over all 20 frames, so they are held
# exactly and the rest to ~3.5-4.5 times the two bands together.
PHOTO_CROSS_TOL = {
    "vio_trans_err_m": 2e-4, "vio_quat_err": 4e-5, "cov_rel_err": 1e-3,
    "chi2_mismatch": 0, "live_mismatch": 0,
}
ORACLE_DURATION = 4.0       # s: tests/test_batch_oracle.py's problem, cut
FIXED_LAG_DURATION = 0.8    # s of it that the fixed-lag engine replays


def photometric_config(tmp: Path) -> Path:
    """``configs/carla_full.yaml`` with ``vio.use_photometric: true``,
    written into ``tmp``."""
    text = FULL_CONFIG.read_text()
    check(text.count("use_photometric: false") == 1,
          "carla_full.yaml has no single use_photometric switch")
    path = tmp / "carla_full_photometric.yaml"
    path.write_text(text.replace("use_photometric: false",
                                 "use_photometric: true"))
    return path


@contextlib.contextmanager
def recorded_photometric(rec: dict):
    """Keep what the photometric VIO stage sees: ``photometric.run``'s
    arguments and final state (``args``, ``final``), and per frame the
    slots that enter the photometric update live (``live``) and its χ²
    verdicts (``chi2``)."""
    PH = VIL.PH
    run, update = PH.run, PH.photometric_update
    rec.update(live=[], chi2=[])

    def run_(*a, **k):
        rec["args"] = a
        rec["final"], out = run(*a, **k)
        return rec["final"], out

    def update_(cfg, s, *a):
        s_new, chi2_ok = update(cfg, s, *a)
        rec["live"].append(s.lm_valid)
        rec["chi2"].append(chi2_ok)
        return s_new, chi2_ok
    PH.run, PH.photometric_update = run_, update_
    try:
        yield
    finally:
        PH.run, PH.photometric_update = run, update


def compare_photometric(a: tuple, b: tuple, n: int) -> dict:
    """Largest differences between two photometric VIO runs ``(VioOutput,
    recorded)`` over their first ``n`` frames, and the first frame whose
    χ² verdicts or live slots differ (None if none does)."""
    (oa, ra), (ob, rb) = a, b
    np_ = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    pa, pb = np_(oa.pose[:n]), np_(ob.pose[:n])
    ca, cb = np_(oa.cov[:n]), np_(ob.cov[:n])
    ga = np.stack([np_(c) for c in ra["chi2"][:n]])
    gb = np.stack([np_(c) for c in rb["chi2"][:n]])
    la = np.stack([np_(c) for c in ra["live"][:n]])
    lb = np.stack([np_(c) for c in rb["live"][:n]])
    differ = np.flatnonzero((ga != gb).any(-1) | (la != lb).any(-1))
    return {
        "frames": n,
        "vio_trans_err_m": float(np.abs(pa[:, 4:] - pb[:, 4:]).max()),
        "vio_quat_err": float(np.abs(pa[:, :4] - pb[:, :4]).max()),
        "cov_rel_err": float((np.linalg.norm(ca - cb, axis=(1, 2))
                              / np.linalg.norm(cb, axis=(1, 2))).max()),
        "chi2_mismatch": int((ga != gb).sum()),
        "live_mismatch": int((la != lb).sum()),
        "first_differing_frame": int(differ[0]) if len(differ) else None}


def rerun_photometric(rec: dict, n: int, dev, dtype=torch.float32):
    """``photometric.run`` again over the first ``n`` frames of a recorded
    run, on ``dev`` in ``dtype``. Returns (VioOutput, recorded)."""
    cfg, fcfg, ps0, pyrs, cu, cs, cd, projs, iw = rec["args"]
    move = lambda t: t.to(dev, dtype if t.is_floating_point()  # noqa: E731
                          else t.dtype)
    head = lambda x: _tree.tree_map(lambda t: move(t[:n]), x)  # noqa: E731
    again = {}
    with recorded_photometric(again):
        _, out = VIL.PH.run(cfg, fcfg, _tree.tree_map(move, ps0), head(pyrs),
                            head(cu), head(cs), head(cd), head(projs),
                            head(iw))
    return out, again


def drive_oracle(dev) -> dict:
    """``oracle_report.build_problem`` (noise 0) in f64 on the card against
    the same on the CPU: the batch MAP's poses within 1e-9 m, ``n_between``
    equal, cost within 1e-9 relative; then ``oracle_report.run_window``
    with a 6-keyframe window on the card over the first
    ``FIXED_LAG_DURATION`` s against the card's oracle of that timeline
    (tests/test_batch_oracle.py's bounds)."""
    from vil_sensor_fusion_tpu_torch import oracle_report as OR

    card = OR.build_problem(ORACLE_DURATION, 0.0, device=dev)
    cpu = OR.build_problem(ORACLE_DURATION, 0.0, device="cpu")
    cb, pb = card["batch"], cpu["batch"]
    nums = {
        "states": int(cb.poses.shape[0]), "n_between": cb.n_between,
        "card_s": card["wall_batch"], "cpu_s": cpu["wall_batch"],
        "cost": cb.cost, "ate_batch_m": card["ate_batch"],
        "pose_err_m": float((cb.poses.cpu() - pb.poses).abs().max()),
        "vel_err": float((cb.vels.cpu() - pb.vels).abs().max()),
        "bias_err": float((cb.biases.cpu() - pb.biases).abs().max()),
        "cost_rel_err": abs(cb.cost - pb.cost) / max(abs(pb.cost), 1.0)}
    check(cb.poses.device == dev and cb.poses.dtype == torch.float64,
          "the oracle left the card or float64")
    check(bool(torch.isfinite(cb.poses).all()), "non-finite oracle pose")
    check(cb.n_between == pb.n_between and cb.n_between > 100,
          f"oracle n_between {cb.n_between} / {pb.n_between}")
    check(nums["pose_err_m"] <= 1e-9, f"oracle card vs CPU poses "
          f"{nums['pose_err_m']} m")
    check(nums["cost_rel_err"] <= 1e-9, f"oracle card vs CPU cost "
          f"{nums['cost_rel_err']}")

    prob = OR.build_problem(FIXED_LAG_DURATION, 0.0, device=dev)
    case = OR.run_window(prob, FIXED_LAG_DURATION, 0.0, 6)
    nums.update(fixed_lag_events=case["events"],
                fixed_lag_oracle_s=prob["wall_batch"],
                fixed_lag_run_s=case["wall_stream_s"],
                gap_max_m=case["delta_max_m"],
                gap_mean_m=case["delta_mean_m"],
                fixed_lag_case=case)
    print("  oracle: " + json.dumps(nums), flush=True)
    check(bool(np.isfinite([case["delta_max_m"], case["delta_mean_m"],
                            case["ate_stream_m"]]).all()),
          "non-finite fixed-lag pose")
    check(nums["gap_max_m"] < 0.05 and nums["gap_mean_m"] < 0.02,
          f"fixed-lag vs full MAP gap {nums['gap_max_m']} / "
          f"{nums['gap_mean_m']} m")
    return nums


def replay_bag_photometric(dev, tmp: Path, geo: dict) -> dict:
    """Phase 10: phase 8's bag again through ``cli run --bag --config``
    with ``vio.use_photometric: true`` (images → pyramids and candidates →
    the direct photometric EKF; LiDAR odometry, gate and fusion as in phase
    8), checked; the kernel against knn_torch on every k-NN call; the
    photometric VIO's first frames rerun on the CPU."""
    config = photometric_config(tmp)
    cfg = C.load(str(config)).vil()
    check(cfg.vio.use_photometric, "the photometric config is not")
    calls, rec = [], {}
    with recorded_photometric(rec):
        run = run_cli_bag(geo["bag"], tmp / "engine_photometric.npz", dev,
                          calls, config=config)
    res, ba = run["res"], run["ba"]
    T, Tv = len(ba.lidar_times), len(ba.cam_times)
    out, st = run["json"], run["stage_s"]
    events = out["events"]
    vio = res.vio_out.pose.cpu().double().numpy()
    vio_cov = res.vio_out.cov.cpu().double().numpy()
    fused = res.fused.poses.cpu().numpy()
    live = (torch.stack(rec["live"]) * torch.stack(rec["chi2"])).cpu()
    geo_st = geo["numbers"]["stage_s"]
    nums = {
        "cli": out, "wall_s": run["wall_s"], "stage_s": st,
        "events_per_s": events / run["wall_s"],
        "vio_s_per_frame": st["vio"] / Tv,
        "geometric_vio_tracker_s_per_frame": (geo_st["vio"]
                                              + geo_st["tracker"]) / Tv,
        "launches": run["launches"], "sweeps": T, "frames": Tv,
        "vio_ate_m": ate(vio, ba.gt_poses),
        "live_share": float(live[1:].mean()),
        "tmpl_ok": float(rec["final"].tmpl_ok.sum()),
        "chi2_pass_share": float(torch.stack(rec["chi2"])[1:].mean())}
    print("  " + json.dumps(nums), flush=True)
    check(fused.shape == (events, 7) and events == T + Tv,
          f"photometric replay: {events} events, fused {fused.shape}")
    check(bool(np.isfinite(fused).all()), "photometric replay: non-finite "
          "fused pose")
    check(bool(np.isfinite(vio_cov).all()) and bool(
        (np.diagonal(vio_cov, axis1=-2, axis2=-1) > 0).all()),
        "photometric replay: VIO covariance not finite / positive")
    check(nums["vio_ate_m"] < 0.5, f"photometric VIO ATE "
          f"{nums['vio_ate_m']} m")
    check(out["fused_ate_rmse_m"] < 1.0,
          f"photometric replay fused ATE {out['fused_ate_rmse_m']} m")
    check(nums["live_share"] > 0.5, f"photometric live share "
          f"{nums['live_share']} <= 0.5")
    check(nums["tmpl_ok"] > 0, "photometric replay captured no template")
    check(out["gate_keep_fraction"] > 0.5,
          f"photometric replay gate keep share {out['gate_keep_fraction']}")
    want = geo["cpu_knn_calls_per_sweep"] * T
    check(run["launches"] == want, f"photometric replay: {run['launches']} "
          f"k-NN launches, want {want}")

    print(f"[kernel vs plain on the photometric replay] its {len(calls)} "
          f"k-NN calls", flush=True)
    max_err = check_drive_knn(calls)
    calls.clear()

    n = PHOTO_CPU_FRAMES
    print(f"[photometric cross-check] first {n} frames of the photometric "
          f"VIO on the CPU", flush=True)
    t0 = time.perf_counter()
    cpu = rerun_photometric(rec, n, torch.device("cpu"))
    cross = compare_photometric((res.vio_out, rec), cpu, n)
    cross["cpu_s"] = time.perf_counter() - t0
    print("  " + json.dumps(cross), flush=True)
    for key, tol in PHOTO_CROSS_TOL.items():
        check(cross[key] <= tol, f"photometric cross-check {key} "
              f"{cross[key]} > {tol}")

    return {"numbers": nums, "cross": cross, "max_err": max_err}


# --------------------------------------------------------------------------
# Phase 11: cli bench, every stage over 8 lanes
# --------------------------------------------------------------------------

BENCH_LANES = 8         # the bench's BATCH (bench.py:64), 8 town seeds
BENCH_DURATION = 0.3    # s per lane: 3 sweeps and 6 frames, 9 events
BENCH_REPS = 1


def as_run(out, b: int | None = None):
    """A ``bench.PassOutput`` (lane ``b`` of it, when given) in
    :func:`compare_runs`'s (frames, result) form."""
    pick = (lambda t: t) if b is None else (lambda t: t[b])  # noqa: E731
    return (_tree.tree_map(pick, out.frames), types.SimpleNamespace(
        vio_out=_tree.tree_map(pick, out.vio),
        lidar_out=_tree.tree_map(pick, out.lidar),
        fused=_tree.tree_map(pick, out.fused)))


def drive_bench_lanes(dev) -> dict:
    """Phase 11: ``cli.main(["bench", ...])`` on the card at the bench's
    rig, 8 distinct town seeds as lanes over BENCH_DURATION s, one timed
    pass. The inputs of every lane-batched k-NN call of its cold pass are
    kept; the run's ``bench.BenchResult`` and stdout line are read back."""
    from vil_sensor_fusion_tpu_torch import bench as BN

    seen, calls, passes = {}, [], [0]
    lanes_kernel = K.knn_cuda_lanes

    def record(q, t, m, *args, **kwargs):
        if passes[0] == 1:
            calls.append((q.clone(), t.clone(), m.clone()))
        return lanes_kernel(q, t, m, *args, **kwargs)

    def count_passes(fn):
        def counted(*a, **kw):
            passes[0] += 1
            return fn(*a, **kw)
        return counted

    def keep(fn):
        return lambda **kw: seen.setdefault("res", fn(**kw))

    out = io.StringIO()
    argv = ["bench", "--lanes", str(BENCH_LANES), "--duration",
            str(BENCH_DURATION), "--reps", str(BENCH_REPS), "--device",
            str(dev)]
    sync = _sync_of(dev)
    sync()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with wrapped((K, "knn_cuda_lanes", lambda fn: record),
                 (BN, "lanes_pass", count_passes),
                 (BN, "main", keep)), contextlib.redirect_stdout(out):
        cli.main(argv)
    sync()
    wall = time.perf_counter() - t0
    res = seen["res"]
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    x, o, o1, diag = res.inputs, res.lanes_out, res.single_out, res.diag
    B, T_l, T_v = BENCH_LANES, len(x.lidar_times), len(x.vio_times)
    ates = {
        "vio_ate_m": [ate(o.vio.pose[b].cpu().numpy(), x.gt_vio[b])
                      for b in range(B)],
        "lidar_ate_m": [ate(o.lidar.pose[b].cpu().numpy(), x.gt_lidar[b])
                        for b in range(B)],
        "fused_ate_m": [ate(o.fused.poses[b].cpu().numpy(), x.gt_events[b])
                        for b in range(B)]}
    nums = {"argv": argv, "line": line, "cli_wall_s": wall,
            "lanes": B, "sweeps": T_l, "frames": T_v,
            "events_per_lane": T_l + T_v,
            "events_per_s": diag["events_per_s"],
            "wall_s_per_batched_pass": diag["wall_s_per_batched_pass"],
            "single_stream_wall_s": diag["single_stream_wall_s"],
            "single_stream_events_per_s": diag["single_stream_events_per_s"],
            "stages_ms_batched": diag["stages_ms_batched"],
            "stages_ms_single": diag["stages_ms_single"],
            **{k: diag[k] for k in (
                "knn_launches_per_pass", "knn_launches_lanes",
                "knn_launches_per_single_pass",
                "knn_launches_single_stream")},
            "knn_microbench": diag["knn_kernel"],
            "live_share": [float(o.frames.obs_valid[b, 2:].mean())
                           for b in range(B)],
            "keep_share": [float(o.gate.keep[b].mean()) for b in range(B)],
            **ates,
            "lane0_vs_single": compare_runs(as_run(o, 0), as_run(o1), T_l)}
    print("  " + json.dumps(nums), flush=True)
    check(len(lines) == 1 and set(line) == {"metric", "value", "unit",
                                            "vs_baseline"}
          and line["metric"] == "full_vil_events_per_s_per_chip"
          and np.isfinite(line["value"]) and line["value"] > 0,
          f"cli bench printed {lines}")
    check(tuple(o.fused.poses.shape) == (B, T_l + T_v, 7),
          f"lane fused poses shape {tuple(o.fused.poses.shape)}")
    check(bool(torch.isfinite(o.fused.poses).all()),
          "non-finite fused pose in a lane")
    for b in range(B):
        check(ates["vio_ate_m"][b] < 0.5,
              f"lane {b} VIO ATE {ates['vio_ate_m'][b]} m")
        check(ates["lidar_ate_m"][b] < 0.5,
              f"lane {b} LiDAR ATE {ates['lidar_ate_m'][b]} m")
        check(ates["fused_ate_m"][b] < 1.0,
              f"lane {b} fused ATE {ates['fused_ate_m'][b]} m")
    check(diag["knn_launches_per_pass"] == 4 * T_l,
          f"{diag['knn_launches_per_pass']} k-NN launches per pass, want 4 "
          f"per sweep for all lanes ({4 * T_l}), not per lane "
          f"({4 * T_l * B})")
    for key, passes in (("knn_launches_lanes", 1 + BENCH_REPS),
                        ("knn_launches_per_single_pass", 1),
                        ("knn_launches_single_stream", 1 + BENCH_REPS)):
        check(diag[key] == 4 * T_l * passes,
              f"{key} {diag[key]}, want 4 per sweep over {passes} "
              f"pass(es): {4 * T_l * passes}")
    check(len(calls) == 4 * T_l, f"{len(calls)} lane k-NN calls recorded")
    for k, tol in CROSS_TOL.items():
        v = nums["lane0_vs_single"][k]
        check(v <= tol, f"lane 0 vs single {k} {v} > {tol}")
    return {"numbers": nums, "knn_calls": calls}


def check_lane_knn_calls(calls: list) -> float:
    """The lane kernel against knn_torch_lanes on the inputs of a run's
    lane-batched k-NN calls; one line per shape. Returns the largest
    |Δd²|."""
    by_shape: dict = {}
    for n, (q, t, m) in enumerate(calls):
        _, _, err, tol, sep = compare_knn_lanes(f"lane call {n}", q, t, m)
        row = by_shape.setdefault(tuple(q.shape[:2]) + (t.shape[1],),
                                  [0, 0.0, 0.0, 0, 0])
        row[0] += 1
        row[1] = max(row[1], err)
        row[2] = max(row[2], tol)
        row[3] += int(sep.sum())
        row[4] += sep.numel()
    for (B, Q, M), (n, err, tol, n_sep, n_slots) in sorted(by_shape.items()):
        print(f"  lanes {B}x{Q:5d}x{M:<5d} {n:3d} calls ok   max|Δd²| "
              f"{err:.3g}  (tol {tol:.3g})  indices checked at the {n_sep} "
              f"of {n_slots} slots whose neighbours are separated",
              flush=True)
    return max(r[1] for r in by_shape.values())


# --------------------------------------------------------------------------
# Phase 12: the long-drive soak, chunked with carried state
# --------------------------------------------------------------------------

SOAK_DURATION = 1.0     # s of the soak's drive: 2 chunks, 10 sweeps
SOAK_CHUNK = 0.5        # s per chunk: 5 sweeps and 10 frames, 15 events


def drive_soak(dev) -> dict:
    """Phase 12: ``soak.run_soak`` on the card at its full width (the
    800×600 camera, 24 landmarks, full sweeps, the soak's rig) with the
    checkpoint test: the first chunk, the second from the carried state,
    then the second again from the checkpoint restored into a fresh
    template. Every fused pose of the three chunk runs is kept for the
    finiteness check, and the inputs of every k-NN call of the first chunk
    for the kernel check; the first chunk's sweeps for a CPU count of the
    k-NN calls per sweep."""
    from vil_sensor_fusion_tpu_torch import soak as SK

    runs, fused, calls, first = [0], [], [], {}

    def count_chunks(fn):
        def run(rig, idx, state, py, cu, cs, cd, prj, imu_w, sweeps, *a):
            runs[0] += 1
            if runs[0] == 1:
                first.update(lidar=rig.lidar, sweeps=sweeps)
            new_state, out = fn(rig, idx, state, py, cu, cs, cd, prj, imu_w,
                                sweeps, *a)
            fused.append(out.fused.poses)
            return new_state, out
        return run

    def record(fn):
        def knn(q, t, m, *args, **kwargs):
            if runs[0] == 1:
                calls.extend(zip(q.clone(), t.clone(), m.clone()))
            return fn(q, t, m, *args, **kwargs)
        return knn

    sync = _sync_of(dev)
    sync()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with wrapped((SK, "estimator_chunk", count_chunks),
                 (K, "knn_cuda_lanes", record)), tempfile.TemporaryDirectory(
                     dir=REPO / "build") as tmp:
        summary, metrics = SK.run_soak(
            duration=SOAK_DURATION, chunk=SOAK_CHUNK, cam_w=CAM_W,
            cam_h=CAM_H, landmarks=N_SLOTS, checkpoint_test=True,
            checkpoint_dir=tmp, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = K.KERNEL_LAUNCHES
    sweeps_per_chunk = round(SOAK_CHUNK * 10)
    per_sweep = {}
    for q, t, _ in calls:
        key = f"{q.shape[0]}x{t.shape[0]}"
        per_sweep[key] = per_sweep.get(key, 0) + 1
    per_sweep = {k: v // sweeps_per_chunk for k, v in per_sweep.items()}
    cpu_per_sweep = knn_calls_per_sweep_cpu(first["lidar"], first["sweeps"])
    nums = {
        "summary": summary, "wall_s": wall, "chunk_runs": runs[0],
        "per_chunk": [{k: m[k] for k in (
            "chunk", "t0", "wall_s", "wall_pyr", "wall_cand", "wall_est",
            "err_max", "vio_err_max", "lidar_err_max", "map_corner",
            "map_surf", "keep", "healthy")} | {
            "realtime_factor": SOAK_CHUNK / m["wall_s"],
            "events_per_s": 3 * sweeps_per_chunk / m["wall_s"]}
            for m in metrics],
        "launches": launches, "knn_calls_per_sweep": per_sweep,
        "cpu_knn_calls_per_sweep": cpu_per_sweep}
    print("  " + json.dumps(nums), flush=True)
    lidar = first["lidar"]
    check(runs[0] == 3 and len(metrics) == 2,
          f"{runs[0]} chunk runs, {len(metrics)} chunk metrics")
    check(all(bool(torch.isfinite(p).all()) for p in fused),
          "soak: non-finite fused pose")
    check(summary["err_max_m"] < 0.05 * summary["distance_m"],
          f"soak drift {summary['err_max_m']} m over "
          f"{summary['distance_m']} m")
    check(summary["healthy_mean"] > 0.95,
          f"soak healthy share {summary['healthy_mean']}")
    check(summary["keep_mean"] > 0.5,
          f"soak gate keep share {summary['keep_mean']}")
    check(1000 < summary["map_surf_final"] <= lidar.surf_map.capacity
          and 0 < summary["map_corner_final"] <= lidar.corner_map.capacity,
          f"soak maps {summary['map_corner_final']} / "
          f"{summary['map_surf_final']}")
    check(summary["resume_max_delta"] == 0.0,
          f"soak checkpoint resume differs by "
          f"{summary['resume_max_delta']}")
    check(launches == cpu_per_sweep * sweeps_per_chunk * runs[0],
          f"soak: {launches} k-NN launches, want {cpu_per_sweep} per sweep "
          f"({cpu_per_sweep * sweeps_per_chunk * runs[0]})")
    check(len(calls) == cpu_per_sweep * sweeps_per_chunk,
          f"soak: {len(calls)} k-NN calls recorded in the first chunk")
    return {"numbers": nums, "knn_calls": calls}


# --------------------------------------------------------------------------
# Phase 13: the five user scripts, as modules of the port
# --------------------------------------------------------------------------

# profile_stages at the bench's 400x300 rig, depth cut to 4 frames and 2
# sweeps (6 fusion events) and one timed call per row.
PROFILE_ARGV = ["--res", "400x300", "--frames", "4", "--sweeps", "2"]
PROFILE_REPS = 1
PROFILE_KNN_ROW = "register 6 iters (map stage)"
# lidar_ablation over the bench's 8 lanes, cut to 0.3 s (3 sweeps) and one
# timed call per candidate.
ABLATION_ARGV = ["--duration", "0.3", "--batch", "8", "--reps", "1"]
ABLATION_SWEEPS, ABLATION_REPS = 3, 1
MULTIHOST_EVENTS = 6    # fusion events per sequence (the workload's 48)
WINDOW_ARGV = ["--duration", "0.3", "--windows", "4"]


def narrow_maps(cfg: L.LidarOdomConfig) -> L.LidarOdomConfig:
    """``cfg`` with small maps and submaps: the same k-NN calls per step
    (their count does not depend on the sizes), counted on the CPU in a
    moment. Counting resets the launch counter: count after reading it."""
    return cfg._replace(
        corner_map=vm.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=vm.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024)


@functools.lru_cache(maxsize=1)
def cpu_sweep() -> L.Sweep:
    """A full VLP-16 sweep of the town on the CPU, as a drive of one."""
    from vil_sensor_fusion_tpu_torch.data import raycast as RC

    sweep = RC.raycast(RC.town_world(seed=7, device="cpu"),
                       torch.tensor([1.0, 0, 0, 0, 0, 0, 1.5]))
    return L.Sweep(*(f[None] for f in sweep))


def step_calls_cpu(cfg: L.LidarOdomConfig) -> int:
    """k-NN calls of one ``odometry.step`` at ``cfg``, counted on the
    CPU."""
    return knn_calls_per_sweep_cpu(narrow_maps(cfg), cpu_sweep(), n=1)


def register_calls_cpu(icp_cfg) -> int:
    """k-NN calls of one ``icp.register`` at ``icp_cfg``, counted on the
    CPU."""
    g = torch.Generator().manual_seed(3)
    pts = lambda n: torch.rand(n, 3, generator=g) * 20.0  # noqa: E731
    ones, calls = torch.ones, []
    with recorded_knn_calls(calls):
        L.icp.register(lie.pose_identity(device="cpu"), pts(64), ones(64),
                       pts(64), ones(64), pts(256), ones(256), pts(256),
                       ones(256), icp_cfg)
    return len(calls)


def drive_profile_stages(dev) -> dict:
    """``profile_stages.run`` at PROFILE_ARGV, every section; the inputs of
    every k-NN call of the map-stage register row kept."""
    from vil_sensor_fusion_tpu_torch import profile_stages as PS

    calls = []

    def record_row(fn):
        def bench(name, f, *a, **kw):
            with (recorded_knn_calls(calls) if name == PROFILE_KNN_ROW
                  else contextlib.nullcontext()):
                return fn(name, f, *a, **kw)
        return bench

    sync = _sync_of(dev)
    sync()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with wrapped((PS, "bench", record_row)):
        rows = PS.run(PS.parse_args(PROFILE_ARGV + ["--device", str(dev)]),
                      reps=PROFILE_REPS)
    sync()
    wall = time.perf_counter() - t0
    launches = K.KERNEL_LAUNCHES
    cfg = PS.lidar_config()
    per_call = {"knn corner 1920x4096": 1, "knn surf 3984x8192": 1,
                PROFILE_KNN_ROW: register_calls_cpu(cfg.icp),
                "register 8 iters (odom stage)":
                    register_calls_cpu(cfg.odom_icp),
                "odometry.step FULL (two_stage)": step_calls_cpu(cfg),
                "odometry.step FULL (single)":
                    step_calls_cpu(cfg._replace(two_stage=False))}
    calls_per_row = 1 + PROFILE_REPS
    nums = {"wall_s": wall, "rows": len(rows), "launches": launches,
            "cpu_knn_calls_per_call": per_call,
            "ms": {k: r["ms"] for k, r in rows.items()}}
    print("  profile_stages: " + json.dumps(nums), flush=True)
    check(len(rows) == 21, f"profile_stages ran {len(rows)} rows, want 21")
    for name, r in rows.items():
        check(np.isfinite(r["ms"]) and np.isfinite(r["first_call_s"])
              and r["ms"] > 0, f"profile_stages {name}: time {r}")
        want = calls_per_row * per_call.get(name, 0)
        check(r["knn_launches"] == want, f"profile_stages {name}: "
              f"{r['knn_launches']} k-NN launches, want {want}")
    check(launches == calls_per_row * sum(per_call.values()),
          f"profile_stages: {launches} k-NN launches in all")
    check(len(calls) == calls_per_row * per_call[PROFILE_KNN_ROW],
          f"profile_stages: {len(calls)} k-NN calls recorded")
    return {"numbers": nums, "knn_calls": calls}


def drive_lidar_ablation(dev) -> dict:
    """``lidar_ablation.main`` at ABLATION_ARGV: the six candidates over 8
    lanes; the inputs of every lane k-NN call of the first candidate's
    first (untimed) call kept."""
    from vil_sensor_fusion_tpu_torch import lidar_ablation as LA

    runs, calls = [0], []
    lanes_kernel = K.knn_cuda_lanes

    def record(q, t, m, *args, **kwargs):
        if runs[0] == 1:
            calls.append((q.clone(), t.clone(), m.clone()))
        return lanes_kernel(q, t, m, *args, **kwargs)

    def count_runs(fn):
        def run(*a, **kw):
            runs[0] += 1
            return fn(*a, **kw)
        return run

    sync = _sync_of(dev)
    sync()
    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with wrapped((K, "knn_cuda_lanes", lambda fn: record),
                 (L.odometry, "run_lanes", count_runs)):
        res = LA.main(ABLATION_ARGV + ["--device", str(dev)])
    sync()
    wall = time.perf_counter() - t0
    launches = K.KERNEL_LAUNCHES
    per_sweep = {name: step_calls_cpu(cfg)
                 for name, cfg in LA.CANDIDATES.items()}
    nums = {"wall_s": wall, "candidates": res, "launches": launches,
            "cpu_knn_calls_per_sweep": per_sweep}
    print("  lidar_ablation: " + json.dumps(nums), flush=True)
    calls_per_candidate = 1 + ABLATION_REPS
    check(list(res) == list(LA.CANDIDATES) and runs[0] == len(res)
          * calls_per_candidate, f"lidar_ablation: {runs[0]} lane runs of "
          f"{list(res)}")
    for name, r in res.items():
        check(all(np.isfinite([r["lidar_stage_ms"], r["err_mean_m"],
                               r["err_max_m"], r["first_call_s"]])),
              f"lidar_ablation {name}: {r}")
        check(r["err_max_m"] < 0.5, f"lidar_ablation {name}: error max "
              f"{r['err_max_m']} m")
        check(r["knn_launches_per_sweep"] == per_sweep[name],
              f"lidar_ablation {name}: {r['knn_launches_per_sweep']} k-NN "
              f"launches per sweep for all lanes, want {per_sweep[name]}")
    want = calls_per_candidate * ABLATION_SWEEPS * sum(per_sweep.values())
    check(launches == want, f"lidar_ablation: {launches} k-NN launches, "
          f"want {want}")
    first = per_sweep[next(iter(LA.CANDIDATES))]
    check(len(calls) == ABLATION_SWEEPS * first,
          f"lidar_ablation: {len(calls)} lane k-NN calls recorded")
    return {"numbers": nums, "knn_calls": calls}


def drive_icp_scaling(dev, per_step: int) -> dict:
    """``icp_scaling_curve.main(["--sizes", "1"])``: a world of one NCCL
    rank in a child process (this process's group is gone since phase 9);
    its k-NN launches as the child counts them, against ``per_step`` (a
    CPU count of one step's calls) per step."""
    from vil_sensor_fusion_tpu_torch import icp_scaling_curve as IC

    t0 = time.perf_counter()
    out = IC.main(["--sizes", "1", "--device", str(dev)])
    row = out["1"]
    nums = {"wall_s": time.perf_counter() - t0, "curve": out,
            "cpu_knn_calls_per_step": per_step}
    print("  icp_scaling_curve: " + json.dumps(nums), flush=True)
    check(np.isfinite(row["step_ms"]) and row["step_ms"] > 0,
          f"icp_scaling_curve step {row['step_ms']} ms")
    check(row["n_corr"] > 0, f"icp_scaling_curve n_corr {row['n_corr']}")
    want = (2 + IC.REPS) * per_step
    check(row["knn_launches"] == want, f"icp_scaling_curve: "
          f"{row['knn_launches']} k-NN launches, want {want}")
    return {"numbers": nums, "launches": row["knn_launches"]}


def drive_multihost(dev) -> dict:
    """``multihost_bench.run_cluster(1, 1)`` as a real worker process on
    the card, cut to MULTIHOST_EVENTS events and one timed pass."""
    from vil_sensor_fusion_tpu_torch import multihost_bench as MB

    t0 = time.perf_counter()
    r = MB.run_cluster(1, 1, n_events=MULTIHOST_EVENTS, reps=1, device=dev)
    nums = {"wall_s": time.perf_counter() - t0, "result": r}
    print("  multihost_bench: " + json.dumps(nums), flush=True)
    check(r["device"] == "cuda" and r["processes"] == 1,
          f"multihost_bench ran {r}")
    check(r["global_events"] == 1 * r["processes"] * MULTIHOST_EVENTS,
          f"multihost_bench global_events {r['global_events']}")
    check(np.isfinite(r["events_per_s"]) and r["events_per_s"] > 0,
          f"multihost_bench events/s {r['events_per_s']}")
    return nums


def drive_window_sweep(dev) -> dict:
    """``window_sweep_quick.main`` at WINDOW_ARGV, float64 on the card."""
    from vil_sensor_fusion_tpu_torch import window_sweep_quick as WS

    t0 = time.perf_counter()
    r = WS.main(WINDOW_ARGV + ["--device", str(dev)])
    nums = {"wall_s": time.perf_counter() - t0,
            "ate_stream_m": r["ate_stream_m"]}
    print("  window_sweep_quick: " + json.dumps(nums), flush=True)
    (ate,) = r["ate_stream_m"].values()
    check(np.isfinite(ate) and ate < 0.05,
          f"window_sweep_quick stream ATE {ate} m")
    return nums


# --------------------------------------------------------------------------
# Phase 14: the thesis's evaluation grid
# --------------------------------------------------------------------------

# default_grid (tunnel, field) at phase 7's depth, seed 0 (``cli experiments
# --seeds 1``): its tunnel is phase 7's cell, the same spec and key, which
# phase 7 leaves in the cache.
GRID_DURATION = EXPERIMENT_DURATION


@contextlib.contextmanager
def recorded_map_inserts(rows: list):
    """Append, for every voxel-map insert the path makes, the map's
    capacity and a device tensor of (live slots beyond ``keep_radius`` of
    the sensor, which the insert evicts, slots live after it, the sensor's
    distance from the origin) to ``rows``; no sync."""
    def wrap(insert):
        def record(m, pts, mask, center, cfg):
            new = insert(m, pts, mask, center, cfg)
            d = torch.linalg.vector_norm(m.points - center[None, :], dim=-1)
            evicted = ((m.mask > 0) & (d >= cfg.keep_radius)).sum()
            rows.append((cfg.capacity, torch.stack([
                evicted.to(m.mask.dtype), new.mask.sum(),
                torch.linalg.vector_norm(center).to(m.mask.dtype)])))
            return new
        return record
    with wrapped((vm, "insert_auto", wrap)):
        yield


def map_numbers(rows: list, lidar_cfg: L.LidarOdomConfig) -> dict:
    """Per map (corner, surf) of one run's inserts, one per sweep: its
    capacity, the slots live after the last and the most after any insert,
    the live slots evicted in all, and the first sweep that evicted one
    with the sensor's distance from the origin there."""
    out = {}
    for name, mcfg in (("corner", lidar_cfg.corner_map),
                       ("surf", lidar_cfg.surf_map)):
        r = [v for cap, v in rows if cap == mcfg.capacity]
        if not r:
            continue
        a = torch.stack(r).double().cpu().numpy()
        ev = np.flatnonzero(a[:, 0] > 0)
        out[name] = {
            "capacity": mcfg.capacity, "keep_radius_m": mcfg.keep_radius,
            "live_final": int(a[-1, 1]), "live_max": int(a[:, 1].max()),
            "evicted": int(a[:, 0].sum()),
            "first_evicting_sweep": int(ev[0]) if ev.size else None,
            "distance_there_m": float(a[ev[0], 2]) if ev.size else None,
            "distance_final_m": float(a[-1, 2])}
    return out


def drive_eval_grid(dev, duration: float, cache_dir: str) -> dict:
    """Phase 14: ``eval.experiments.run_batch`` over ``default_grid``
    (tunnel, field; seed 0) on the card, what ``cli experiments --seeds 1``
    runs before it draws its figures, then the numbers of its reports
    without the figures: per cell and pooled, the AUC of every score on
    its typed labels, the calibrated thresholds and the raw-threshold
    parity. A cell already in ``cache_dir`` is loaded, not run. Per run
    cell: scenario and run walls, ``run_vil``'s stage seconds, events/s,
    k-NN launches, ATEs, keep share, the voxel maps' fill and first
    eviction. Every number is printed before the checks: finite fused
    poses and fused ATE < 1.0 m in every cell; the launches of each run
    cell equal to the CPU's per-sweep count; the kernel against
    ``knn_torch`` on every k-NN call of the field cell; its first
    ``CROSS_EXP_SWEEPS`` sweeps again on the CPU in float32, within phase
    7's tolerances."""
    specs = EX.default_grid(seeds=(0,), duration=duration)
    sync = _sync_of(dev)
    ran, calls, field = {}, [], None

    def build(fn):
        def run(spec, cfg, *a, **k):
            sync()
            t0 = time.perf_counter()
            sc = fn(spec, cfg, *a, **k)
            sync()
            ran[spec.key()] = {"scenario_s": time.perf_counter() - t0}
            return sc
        return run

    def score(fn):
        def run(spec, cfg, sc):
            nonlocal field
            rec = calls if spec.kind == "field" else None
            rows, n0, timer = [], K.KERNEL_LAUNCHES, U.StageTimer()
            t0 = time.perf_counter()
            with timed_run_vil_stages(timer), recorded_map_inserts(rows), (
                    recorded_knn_calls(rec) if rec is not None
                    else contextlib.nullcontext()):
                out = fn(spec, cfg, sc)
            sync()
            wall, stages = time.perf_counter() - t0, stage_seconds(timer)
            stages["scoring+other"] = wall - sum(stages.values())
            ran[spec.key()].update(
                wall_s=wall, stage_s=stages,
                launches=K.KERNEL_LAUNCHES - n0,
                maps=map_numbers(rows, cfg.lidar))
            if rec is not None:
                field = (spec, cfg, sc, out)
            return out
        return run

    K.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with wrapped((EX, "experiment_scenario", build),
                 (EX, "run_scenario", score)):
        results = EX.run_batch(specs, cache_dir, dev)
    wall = time.perf_counter() - t0
    launches = K.KERNEL_LAUNCHES

    cells = {}
    for spec, out in zip(specs, results):
        _, lab_t, lab_r = EX._pool_scores([out])
        nums = {"kind": spec.kind, "cached": spec.key() not in ran,
                "sweeps": len(out["lidar_times"]),
                "events": int(out["events"]),
                "degen_windows": out["degen_windows"],
                "labeled_sweeps": {"trans": int(lab_t.sum()),
                                   "rot": int(lab_r.sum())},
                "ate_fused_m": float(out["ate_fused"]),
                "ate_vio_m": float(out["ate_vio"]),
                "ate_lidar_m": float(out["ate_lidar"]),
                "keep_share": float(out["gate_keep_fraction"]),
                "median_n_corr": float(np.median(out["n_corr"]))}
        if spec.key() in ran:
            r = ran[spec.key()]
            nums.update(r, events_per_s=nums["events"] / r["wall_s"])
        nums.update(pooled_numbers([out]))
        cells[spec.kind] = nums
        print("  " + json.dumps(nums), flush=True)
    pooled = pooled_numbers(results)
    print(f"  grid wall {wall:.3f} s, {launches} k-NN launches", flush=True)
    print("  pooled " + json.dumps(pooled), flush=True)

    check([r["spec"]["kind"] for r in results]
          == [s.kind for s in specs], "run_batch: cells out of order")
    for (key, nums), out in zip(cells.items(), results):
        check(bool(np.isfinite(out["fused_poses"]).all()),
              f"{key}: non-finite fused pose")
        check(nums["ate_fused_m"] < 1.0,
              f"{key}: fused ATE {nums['ate_fused_m']} m")
    check(field is not None, "the grid ran no field cell")
    spec, cfg, sc, out = field
    print(f"[kernel vs plain on the field cell] its {len(calls)} k-NN calls",
          flush=True)
    max_err = check_drive_knn(calls)
    calls.clear()
    n = CROSS_EXP_SWEEPS
    print(f"[grid cross-check] the field cell's first {n} sweeps on the CPU",
          flush=True)
    diff, cpu_per_sweep = rerun_cell_cpu(spec, cfg, sc, out, n)
    for key, nums in cells.items():
        if not nums["cached"]:
            want = cpu_per_sweep * nums["sweeps"]
            check(nums["launches"] == want, f"{key}: {nums['launches']} k-NN "
                  f"launches, want {cpu_per_sweep} per sweep ({want})")
    check(launches == sum(c["launches"] for c in cells.values()
                          if not c["cached"]),
          f"the grid launched the kernel {launches} times outside its cells")
    check_cross_experiment(diff)
    return {"cells": cells, "pooled": pooled, "cross": diff,
            "launches": launches, "wall_s": wall, "max_err": max_err}


def _card():
    """The first card, with the port's precision set, for a phase run
    alone; raises without one."""
    check(torch.cuda.is_available(), "no CUDA device")
    _precision.require_full_f32()
    print(f"card: {card_line()}", flush=True)
    return torch.device("cuda", 0)


def eval_grid(duration: float) -> dict:
    """Phase 14 alone at another depth, every cell run (nothing cached),
    for a record on the card:

        python3 -c 'import chip_smoke as CS; CS.eval_grid(15.0)'
    """
    dev = _card()
    print(f"[evaluation grid] default_grid, seed 0, {duration} s per cell "
          f"-> run_batch", flush=True)
    with tempfile.TemporaryDirectory() as cache:
        return drive_eval_grid(dev, duration, cache)


def bag_replays(duration: float) -> dict:
    """Phases 8 and 10's bag replays alone on a ``duration`` s bag,
    geometric then photometric, with their checks:

        python3 -c 'import chip_smoke as CS; CS.bag_replays(5.0)'
    """
    dev = _card()
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        print(f"[bag replay] {duration} s town drive at {FULL_CONFIG.name}'s "
              f"rig -> bz2 bag -> cli run --bag", flush=True)
        geo = replay_bag(dev, Path(tmp), duration)
        print("[photometric bag replay] the same bag -> cli run --bag with "
              "vio.use_photometric: true", flush=True)
        photo = replay_bag_photometric(dev, Path(tmp), geo)
    return {"geometric": geo["numbers"], "photometric": photo["numbers"]}


def main() -> int:
    # Phase 1: the device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    _precision.require_full_f32()
    phase_s, mark = {}, [time.perf_counter()]

    def done(name):
        """Record the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now

    # Phase 2: build the kernel.
    t0 = time.perf_counter()
    K.knn_cuda(torch.zeros(1, 3, device=dev), torch.zeros(1, 3, device=dev),
               torch.ones(1, device=dev))
    torch.cuda.synchronize()
    log, build_s = _build.build_info("knn")
    print(f"[build] knn kernel ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build_s:.2f} s)\n{log.strip()}", flush=True)

    # Phase 3: kernel vs plain, then its times at the main-path shapes.
    print("[kernel vs plain] k-NN, k=5", flush=True)
    max_err = check_knn_cases(dev)
    print(f"[kernel vs plain, lanes] k-NN, k=5, {KNN_LANES} lanes in one "
          f"launch", flush=True)
    lane_max_err = check_knn_lane_cases(dev)
    print("[kernel times] k-NN, k=5, us per call", flush=True)
    shapes = time_knn_shapes(dev)
    print(f"[kernel times, lanes] k-NN, k=5, {KNN_LANES} lanes, us per call",
          flush=True)
    lane_shapes = time_knn_lane_shapes(dev)
    done("build_and_kernel")

    # Phase 4: the image-driven full path on the card.
    cfg, fcfg = main_path_config()
    print(f"[full path] town drive {DURATION} s, {CAM_W}x{CAM_H} camera, "
          f"{N_SLOTS} slots: tracker -> run_vil", flush=True)
    sc, x = make_inputs(cfg, dev, DURATION, from_images=True)
    full = drive_full_path(cfg, fcfg, sc, x)
    print(f"[kernel vs plain on the drive] the cold run's "
          f"{len(full['knn_calls'])} k-NN calls", flush=True)
    max_err = max(max_err, check_drive_knn(full.pop("knn_calls")))
    launches_4 = full["numbers"]["launches"][1]
    done("full_path")

    # Phase 5: synthetic feature tracks, shorter.
    print(f"[synthetic tracks] town drive {SHORT_DURATION} s -> run_vil",
          flush=True)
    drive_synthetic_tracks(cfg, fcfg, dev)
    done("synthetic_tracks")

    # Phase 6: CPU cross-check of the image-driven run.
    print(f"[cross-check] first {CROSS_SWEEPS} sweeps on the CPU", flush=True)
    cross_check(cfg, fcfg, x, (full["frames"], full["result"]))
    src9 = lane_source(x, full["result"])
    del full, x, sc
    done("cross_check")

    # Phase 7: the degeneracy-experiment grid. Its tunnel cell goes into
    # the experiment cache that phase 14 reads.
    print(f"[experiments] smoke grid, {EXPERIMENT_DURATION} s per cell: "
          f"experiment_config -> experiment_scenario -> run_scenario",
          flush=True)
    cache_dir = tempfile.TemporaryDirectory()
    exp = drive_experiments(dev, cache_dir.name)
    max_err = max(max_err, exp["max_err"])
    done("experiments")

    # Phase 8: raw-sensor bag replay through the CLI at the reference rig.
    # The bag stays in build/ until phase 10 has replayed it again.
    print(f"[bag replay] {BAG_DURATION} s town drive at "
          f"{FULL_CONFIG.name}'s rig -> bz2 bag -> cli run --bag", flush=True)
    (REPO / "build").mkdir(exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(dir=REPO / "build")
    tmp = Path(tmp_dir.name)
    bag = replay_bag(dev, tmp)
    max_err = max(max_err, bag["max_err"])
    done("bag_replay")

    # Phase 9: lanes and collectives on a one-rank mesh of the card.
    print(f"[lanes and collectives] {LANES} lanes of phase 4's first "
          f"{LANE_EVENTS} events -> batched_fusion_run; sharded LiDAR step, "
          f"window solve on a one-rank NCCL mesh", flush=True)
    par = drive_lanes_and_collectives(cfg, src9, dev)
    print(f"[kernel vs plain on the sharded step] "
          f"{len(par['knn_calls'])} k-NN calls", flush=True)
    max_err = max(max_err, check_drive_knn(par.pop("knn_calls")))
    dist.destroy_process_group()
    done("lanes_and_collectives")

    # Phase 10: phase 8's bag through the photometric VIO; the oracle.
    print(f"[photometric bag replay] phase 8's bag -> cli run --bag with "
          f"vio.use_photometric: true", flush=True)
    photo = replay_bag_photometric(dev, tmp, bag)
    tmp_dir.cleanup()
    max_err = max(max_err, photo["max_err"])
    print(f"[oracle] graph.batch.solve_batch, f64, {ORACLE_DURATION} s "
          f"circle: card vs CPU; fixed-lag fusion.run over "
          f"{FIXED_LAG_DURATION} s against it", flush=True)
    drive_oracle(dev)
    done("photometric_and_oracle")

    # Phase 11: cli bench, every stage batched over 8 lanes.
    print(f"[bench lanes] cli bench --lanes {BENCH_LANES} --duration "
          f"{BENCH_DURATION} --reps {BENCH_REPS}: {BENCH_LANES} town seeds "
          f"at {CAM_W}x{CAM_H}, every stage over the lanes", flush=True)
    bench = drive_bench_lanes(dev)
    print(f"[kernel vs plain on the bench lanes] the cold pass's "
          f"{len(bench['knn_calls'])} lane k-NN calls", flush=True)
    lane_max_err = max(lane_max_err,
                       check_lane_knn_calls(bench.pop("knn_calls")))
    done("bench_lanes")

    # Phase 12: the long-drive soak, chunked, with the checkpoint test.
    print(f"[soak] soak.run_soak {SOAK_DURATION} s in {SOAK_CHUNK} s chunks "
          f"at {CAM_W}x{CAM_H}, {N_SLOTS} landmarks, checkpoint test",
          flush=True)
    soak = drive_soak(dev)
    print(f"[kernel vs plain on the soak] the first chunk's "
          f"{len(soak['knn_calls'])} k-NN calls", flush=True)
    max_err = max(max_err, check_drive_knn(soak.pop("knn_calls")))
    done("soak")

    # Phase 13: the five user scripts, as modules of the port. The two that
    # start processes run beside the three in-process ones, in threads.
    print("[scripts] profile_stages, lidar_ablation, icp_scaling_curve, "
          "multihost_bench, window_sweep_quick on the card", flush=True)
    from vil_sensor_fusion_tpu_torch import icp_scaling_curve as IC
    icp_per_step = step_calls_cpu(IC.problem("cpu")[0])
    with ThreadPoolExecutor(2) as pool:
        icp_run = pool.submit(drive_icp_scaling, dev, icp_per_step)
        mh_run = pool.submit(drive_multihost, dev)
        prof = drive_profile_stages(dev)
        print(f"[kernel vs plain on the profile] the {PROFILE_KNN_ROW} row's "
              f"{len(prof['knn_calls'])} k-NN calls", flush=True)
        max_err = max(max_err, check_drive_knn(prof.pop("knn_calls")))
        abl = drive_lidar_ablation(dev)
        print(f"[kernel vs plain on the ablation] the first candidate's "
              f"first call: {len(abl['knn_calls'])} lane k-NN calls",
              flush=True)
        lane_max_err = max(lane_max_err,
                           check_lane_knn_calls(abl.pop("knn_calls")))
        drive_window_sweep(dev)
        icp = icp_run.result()
        mh_run.result()
    done("scripts")

    # Phase 14: the thesis's evaluation grid, default_grid (tunnel, field),
    # as cli experiments runs it up to its figures; the tunnel from phase
    # 7's cache.
    print(f"[evaluation grid] default_grid, seed 0, {GRID_DURATION} s per "
          f"cell -> run_batch (tunnel from phase 7's cache), the reports' "
          f"numbers", flush=True)
    grid = drive_eval_grid(dev, GRID_DURATION, cache_dir.name)
    cache_dir.cleanup()
    max_err = max(max_err, grid["max_err"])
    done("eval_grid")
    print("[phase seconds] " + json.dumps(phase_s), flush=True)

    launches = {"town_image_drive": launches_4}
    launches.update({f"experiments_{k}": c["launches"]
                     for k, c in exp["cells"].items()})
    launches["bag_replay"] = bag["numbers"]["launches"]
    launches["sharded_lidar_step"] = par["numbers"]["model"]["launches"]
    launches["bag_replay_photometric"] = photo["numbers"]["launches"]
    bn = bench["numbers"]
    launches["bench_single_stream"] = bn["knn_launches_single_stream"]
    launches["soak"] = soak["numbers"]["launches"]
    launches["profile_stages"] = prof["numbers"]["launches"]
    launches["icp_scaling_curve"] = icp["launches"]
    launches["eval_grid"] = grid["launches"]
    print(f"card: {card}")
    print(kernels_line(card, launches, max_err, shapes,
                       exp["knn_calls_per_sweep"],
                       bag["numbers"]["knn_calls_per_sweep"],
                       soak["numbers"]["knn_calls_per_sweep"],
                       {"bench_lanes": bn["knn_launches_lanes"],
                        "lidar_ablation": abl["numbers"]["launches"]},
                       lane_max_err,
                       lane_shapes))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

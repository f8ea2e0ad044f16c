"""Full-pipeline throughput at the reference rig, B distinct sequences at
once: the port's counterpart of the repository's ``bench.py`` (which the
JAX package's ``cli bench`` runs), run by this package's ``cli bench``.

    python -m vil_sensor_fusion_tpu_torch.cli bench [--lanes 8]
        [--duration 4.0] [--reps 3] [--device cuda]

It times the complete system on raw sensor streams at the reference's
sensor shapes: an 800×600 camera at 20 Hz and full 16×1800 VLP-16 sweeps at
10 Hz, over ``lanes`` town worlds (one per seed) batched on a lane axis.
Every stage is one set of ops per step for all lanes:

  frontend_pyr     ``frontend.pyramids_batch`` over (B, T, H, W)
  frontend_detect  ``frontend.candidates_batch`` (Shi-Tomasi, LiDAR depth)
  frontend_track   ``frontend.track_frames_lanes`` (KLT, slot replenishment)
  vio              ``pipeline.run_lanes`` (the error-state EKF)
  lidar            ``odometry.run_lanes`` (undistortion, features, two-stage
                   registration, map update; each k-NN search one kernel
                   launch for all lanes)
  gate             ``gate.logdet_gate`` over (B, T, 6, 6)
  fusion           ``engine.run_lanes`` (preintegration, factors, fixed-lag
                   Gauss-Newton)

A warm pass, then ``reps`` timed passes, then lane 0 alone through the
single-sequence stage functions (``track_frames``, ``pipeline.run``,
``odometry.run``, ``logdet_gate``, ``engine.run``), then the k-NN kernel
alone. Rendering and state set-up are untimed.

Baseline semantics as in the JAX round's ``bench.py``: the reference's
fused output runs at its sensor rate, 30 odometry events/s (20 Hz VIO + 10
Hz LiDAR), and the target is 5× that per card, 150 events/s;
``vs_baseline`` = measured events/s ÷ 150. Prints ONE JSON line on stdout,
``{"metric", "value", "unit", "vs_baseline"}``; the per-stage breakdown and
the k-NN microbench go to stderr. ``--device cpu`` runs the same code on
the host (the tests do, at a small rig); its times are the CPU's.
"""

from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import _precision, _tree
from . import fusion as fu
from . import graph as G
from . import utils as U
from .core import lie
from .data import scenarios
from .degeneracy import gate as DG
from .frontends import lidar as L
from .frontends import vio as V
from .frontends.lidar import voxelmap as vm
from .frontends.vio import frontend as F
from .fusion import engine as E
from .fusion import vil as VIL
from .ops import knn as K

REALTIME_EVENTS_PER_S = 30.0
TARGET_MULTIPLIER = 5.0

# The reference rig (bench.py:61-64): 800×600 camera at 20 Hz, 16×1800
# sweeps at 10 Hz, 4 s, 24 landmark slots, 8 distinct sequences.
CAM_W, CAM_H = 800, 600
DURATION = 4.0
N_SLOTS = 24
BATCH = 8
REPS = 3
SWEEP_STRIDE = 4        # azimuth decimation of the depth association


class Rig(NamedTuple):
    """Camera size and LiDAR map sizes; the default is the bench's."""

    cam_w: int = CAM_W
    cam_h: int = CAM_H
    corner_capacity: int = 24576
    surf_capacity: int = 49152
    submap_corners: int = 2048
    submap_surfs: int = 4096


# The rig and the k-NN microbench's Q × M (bench.py:70) that ``run``
# measures, read at call time (the tests set smaller ones).
RIG = Rig()
KNN_SHAPE = (4096, 16384)


class BenchConfig(NamedTuple):
    vio: V.VioConfig
    frontend: F.FrontendConfig
    lidar: L.LidarOdomConfig
    gate: DG.GateConfig
    fusion: fu.FusionConfig


def bench_config(rig: Rig = Rig()) -> BenchConfig:
    """The bench's operating point (bench.py:121-167): fov-100° camera,
    two-stage LOAM with one correspondence round per stage (``fit_every``
    4), the normalised log-det gate (4.0, −6.0), a 6-keyframe window."""
    cam = V.camera.carla_camera(width=rig.cam_w, height=rig.cam_h)
    pose_ic = tuple(float(v) for v in
                    F.forward_camera_extrinsics(torch.float64, device="cpu"))
    return BenchConfig(
        vio=V.VioConfig(num_landmarks=N_SLOTS, update_iters=2, cam=cam,
                        pose_ic=pose_ic),
        frontend=F.FrontendConfig(cam=cam, n_candidates=64, min_dist=24.0,
                                  min_score=0.5),
        lidar=L.LidarOdomConfig(
            icp=L.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                            final_refresh=False, eig_sweeps=3),
            odom_icp=L.IcpConfig(iters=4, max_corr_dist=2.0,
                                 degen_eigval=5.0, fit_every=4,
                                 final_refresh=False, eig_sweeps=3),
            corner_map=vm.VoxelMapConfig(capacity=rig.corner_capacity,
                                         leaf=0.2),
            surf_map=vm.VoxelMapConfig(capacity=rig.surf_capacity, leaf=0.4),
            submap_corners=rig.submap_corners,
            submap_surfs=rig.submap_surfs,
            two_stage=True, undistort=True, guess_is_delta=True),
        gate=DG.GateConfig(rot_threshold=4.0, trans_threshold=-6.0,
                           normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12,
                                      gn_iters=4),
            sensors=VIL.VilConfig().fusion.sensors, max_imu_per_gap=32))


class BenchInputs(NamedTuple):
    """B sequences on one device, every tensor with a leading lane axis
    except the shared stamps."""

    images: torch.Tensor            # (B, Tv, H, W)
    cam_points: torch.Tensor        # (B, Tv, P, 3)
    cam_point_valid: torch.Tensor   # (B, Tv, P)
    imu_windows: tuple              # (accel, gyro, dts), (B, Tv, N, ·)
    sweeps: L.Sweep                 # (B, Tl, R, A, ·)
    imu_times: torch.Tensor         # (B, N)
    imu_accel: torch.Tensor         # (B, N, 3)
    imu_gyro: torch.Tensor          # (B, N, 3)
    pose0: torch.Tensor             # (B, 7)
    vel0: torch.Tensor              # (B, 3)
    vio_times: np.ndarray           # (Tv,) shared
    lidar_times: np.ndarray         # (Tl,) shared
    guess_idx: np.ndarray           # (Tl,) VIO frame of each sweep
    gt_vio: np.ndarray              # (B, Tv, 7)
    gt_lidar: np.ndarray            # (B, Tl, 7)
    gt_events: np.ndarray           # (B, Tv + Tl, 7) at the merged stamps


def _stack(trees):
    return _tree.tree_map(lambda *xs: torch.stack(xs, 0), *trees)


def build_inputs(cfg: BenchConfig, lanes: int, duration: float, device,
                 seed: int = 0) -> BenchInputs:
    """B distinct town drives (seeds ``seed`` … ``seed + B − 1``), each
    built and its camera stream rendered on ``device``
    (bench.py:_lane_arrays), stacked on a lane axis."""
    f32 = torch.float32
    t0 = torch.zeros((), dtype=f32, device=device)
    scs, rendered = [], []
    for b in range(lanes):
        sc = scenarios.build("town", duration=duration, vio_cfg=cfg.vio,
                             dtype=f32, device=device, seed=seed + b)
        scs.append(sc)
        rendered.append(scenarios.render_frontend_inputs(
            sc, cfg.vio.cam, cfg.vio.pose_ic, sweep_stride=SWEEP_STRIDE))
    sc0 = scs[0]
    times = np.concatenate([sc0.vio_times, sc0.lidar_times])
    order = np.argsort(times, kind="stable")
    ev_t = torch.as_tensor(times[order], dtype=f32, device=device)
    return BenchInputs(
        images=torch.stack([r[0] for r in rendered]),
        cam_points=torch.stack([r[1] for r in rendered]),
        cam_point_valid=torch.stack([r[2] for r in rendered]),
        imu_windows=tuple(torch.stack(w) for w in zip(*[
            (sc.vio_frames.accel, sc.vio_frames.gyro, sc.vio_frames.dts)
            for sc in scs])),
        sweeps=_stack([sc.sweeps for sc in scs]),
        imu_times=torch.stack([sc.imu_times for sc in scs]),
        imu_accel=torch.stack([sc.imu_accel for sc in scs]),
        imu_gyro=torch.stack([sc.imu_gyro for sc in scs]),
        pose0=torch.stack([sc.traj.pose_fn(t0) for sc in scs]),
        vel0=torch.stack([sc.traj.vel_fn(t0) for sc in scs]),
        vio_times=np.asarray(sc0.vio_times),
        lidar_times=np.asarray(sc0.lidar_times),
        guess_idx=np.asarray(sc0.lidar_guess_idx),
        gt_vio=np.stack([sc.gt_vio_poses for sc in scs]),
        gt_lidar=np.stack([sc.gt_lidar_poses for sc in scs]),
        gt_events=np.stack([torch.func.vmap(sc.traj.pose_fn)(ev_t)
                            .cpu().numpy() for sc in scs]))


class States(NamedTuple):
    """Every stage's initial state, per lane (leading axis B)."""

    vio: V.VioState
    lidar: L.LidarOdomState
    engine: fu.EngineState


def initial_states(cfg: BenchConfig, x: BenchInputs) -> States:
    dt, dev = x.pose0.dtype, x.pose0.device
    zeros6 = torch.zeros(6, dtype=dt, device=dev)
    t0 = torch.zeros((), dtype=dt, device=dev) - 1e-3
    lanes = range(x.pose0.shape[0])
    return States(
        vio=_stack([V.init(cfg.vio, x.pose0[b], x.vel0[b], zeros6)
                    for b in lanes]),
        lidar=_stack([L.odometry.init(cfg.lidar, dt, pose0=x.pose0[b])
                      for b in lanes]),
        engine=_stack([fu.init(cfg.fusion, x.pose0[b], x.vel0[b], zeros6,
                               t0) for b in lanes]))


def delta_guesses(vio_poses: torch.Tensor, pose0: torch.Tensor,
                  guess_idx: np.ndarray) -> torch.Tensor:
    """(…, Tv, 7) VIO poses → (…, Tl, 7) relative LiDAR priors: the VIO
    motion between consecutive sweep frames, sweep 0 against the initial
    pose (bench.py:207-217; ``lie`` maps over the leading axes)."""
    idx = torch.as_tensor(guess_idx, device=vio_poses.device)
    sel = vio_poses[..., idx, :]
    prev = torch.cat([pose0[..., None, :], sel[..., :-1, :]], dim=-2)
    return lie.pose_between(prev, sel)


def timeline(x: BenchInputs, vio_pose, vio_cov, lidar_pose, lidar_cov,
             lidar_keep) -> fu.Timeline:
    """The merged timeline of every lane (bench.py:259-271): the shared
    stamps in time order, VIO events first among equal stamps; constant
    sensor noise, so the twist channel repeats the pose covariance. Inputs
    and outputs have the same leading axes (none for one lane)."""
    dt, dev = vio_pose.dtype, vio_pose.device
    lead = vio_pose.shape[:-2]
    times = np.concatenate([x.vio_times, x.lidar_times])
    order = torch.as_tensor(np.argsort(times, kind="stable"), device=dev)
    Tv, E_ = len(x.vio_times), len(times)
    src = torch.cat([torch.zeros(Tv, dtype=torch.int32, device=dev),
                     torch.ones(E_ - Tv, dtype=torch.int32, device=dev)])

    def cat(a, b):       # VIO then LiDAR events, in time order
        return torch.index_select(torch.cat([a, b], dim=len(lead)),
                                  len(lead), order)

    cov = cat(vio_cov, lidar_cov)
    return fu.Timeline(
        times=torch.as_tensor(times, dtype=dt, device=dev)[order].repeat(
            lead + (1,)),
        source=src[order].repeat(lead + (1,)),
        odo_pose=cat(vio_pose, lidar_pose), odo_cov=cov,
        keep=cat(torch.ones(lead + (Tv,), dtype=dt, device=dev), lidar_keep),
        valid=torch.ones(lead + (E_,), dtype=dt, device=dev),
        odo_twist_cov=cov)


class PassOutput(NamedTuple):
    frames: V.VioFrameInput
    vio: V.VioOutput
    lidar: L.LidarOdomResult
    gate: DG.GateResult
    fused: fu.FusedOutput


def lanes_pass(cfg: BenchConfig, x: BenchInputs, s: States,
               timer: U.StageTimer) -> PassOutput:
    """One pass of every stage over all lanes (bench.py:one_pass)."""
    fe = cfg.frontend
    py = timer.time("frontend_pyr", F.pyramids_batch, fe, x.images)
    cand = timer.time("frontend_detect", F.candidates_batch, fe, x.images,
                      x.cam_points, x.cam_point_valid)
    frames = timer.time("frontend_track", F.track_frames_lanes, fe, py,
                        *cand, x.imu_windows, cfg.vio.num_landmarks)
    _, vio = timer.time("vio", V.pipeline.run_lanes, cfg.vio, s.vio, frames)
    guesses = delta_guesses(vio.pose, x.pose0, x.guess_idx)
    _, lidar = timer.time("lidar", L.odometry.run_lanes, cfg.lidar, s.lidar,
                          x.sweeps, guesses)
    gate = timer.time("gate", DG.logdet_gate, lidar.hessian, cfg.gate,
                      lidar.n_corr)
    tl = timeline(x, vio.pose, vio.cov, lidar.pose, lidar.cov, gate.keep)
    _, fused = timer.time("fusion", E.run_lanes, cfg.fusion, s.engine, tl,
                          x.imu_times, x.imu_accel, x.imu_gyro)
    return PassOutput(frames, vio, lidar, gate, fused)


def single_pass(cfg: BenchConfig, x: BenchInputs, s: States,
                timer: U.StageTimer, lane: int = 0) -> PassOutput:
    """One lane alone through the single-sequence stage functions
    (bench.py:estimator_single): what a user replaying one drive runs."""
    def one(tree):
        return _tree.tree_map(lambda v: v[lane], tree)

    fe = cfg.frontend
    py = timer.time("frontend_pyr", F.pyramids_batch, fe, x.images[lane])
    cand = timer.time("frontend_detect", F.candidates_batch, fe,
                      x.images[lane], x.cam_points[lane],
                      x.cam_point_valid[lane])
    frames, _ = timer.time("frontend_track", F.track_frames, fe, py, *cand,
                           one(x.imu_windows), cfg.vio.num_landmarks)
    _, vio = timer.time("vio", V.run, cfg.vio, one(s.vio), frames)
    guesses = delta_guesses(vio.pose, x.pose0[lane], x.guess_idx)
    _, lidar = timer.time("lidar", L.odometry.run, cfg.lidar, one(s.lidar),
                          one(x.sweeps), guesses)
    gate = timer.time("gate", DG.logdet_gate, lidar.hessian, cfg.gate,
                      lidar.n_corr)
    tl = timeline(x, vio.pose, vio.cov, lidar.pose, lidar.cov, gate.keep)
    _, fused = timer.time("fusion", E.run, cfg.fusion, one(s.engine), tl,
                          x.imu_times[lane], x.imu_accel[lane],
                          x.imu_gyro[lane])
    return PassOutput(frames, vio, lidar, gate, fused)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def knn_library(q, t, m, k: int = K.K_DEFAULT):
    """The shortest PyTorch expression of the search, ties aside: the
    distance rows from one ``torch.mm``, then ``torch.topk``. A yardstick
    timed beside the kernel; the estimator never calls it."""
    d = ((q * q).sum(1, keepdim=True) - 2.0 * torch.mm(q, t.T)
         + torch.where(m > 0, (t * t).sum(1), torch.inf)[None])
    dist, idx = torch.topk(d, k, dim=1, largest=False)
    return idx, dist


def knn_microbench(device, shape: tuple) -> dict:
    """The k-NN alone at Q × M uniform points in a 100 m box: µs per call,
    best of 3 runs of 20 back-to-back calls ending in a sync, and GFLOP/s
    at 8 FLOP per (query, target) pair; the kernel (on a card only),
    ``knn_torch`` and ``torch.mm`` + ``torch.topk``."""
    Q, M = shape
    reps, trials = 20, 3
    g = torch.Generator().manual_seed(0)
    q = (torch.rand(Q, 3, generator=g) * 100 - 50).to(device)
    t = (torch.rand(M, 3, generator=g) * 100 - 50).to(device)
    m = torch.ones(M, device=device)
    impls = {"plain": K.knn_torch, "library": knn_library}
    if device.type == "cuda":
        impls = {"kernel": K.knn_cuda, **impls}
    out = {}
    for name, fn in impls.items():
        fn(q, t, m)
        _sync(device)
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(q, t, m)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / reps)
        out[name] = {"time_us": best * 1e6,
                     "gflops": 8.0 * Q * M / best / 1e9}
    return out


class BenchResult(NamedTuple):
    line: dict          # the stdout JSON object
    diag: dict          # the stderr breakdown
    inputs: BenchInputs
    lanes_out: PassOutput     # the last timed pass
    single_out: PassOutput    # lane 0 alone, last run


def run(lanes: int = BATCH, duration: float = DURATION, reps: int = REPS,
        device="cuda", log=None) -> BenchResult:
    """Build the lanes at :data:`RIG`, run the warm pass, ``reps`` timed
    passes, lane 0 alone (warm, then ``reps`` timed runs) and the k-NN
    microbench at :data:`KNN_SHAPE`. ``log(msg)`` reports progress. The
    k-NN kernel's launches are counted over the warm lane pass
    (``knn_launches_per_pass``), every lane pass (``knn_launches_lanes``),
    the warm single pass and every single pass."""
    log = log or (lambda msg: None)
    if lanes < 1 or reps < 1 or duration < 0.1:
        raise ValueError(f"bench needs lanes >= 1, reps >= 1 and a duration "
                         f"of at least one sweep (0.1 s); got lanes={lanes}, "
                         f"reps={reps}, duration={duration}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench runs on a CUDA card (--device cuda); "
                           "none is available")
    _precision.require_full_f32()
    rig, knn_shape = RIG, KNN_SHAPE
    cfg = bench_config(rig)
    log(f"building {lanes} distinct town drives of {duration} s and "
        f"rendering their {rig.cam_w}x{rig.cam_h} camera streams on {dev}")
    x = build_inputs(cfg, lanes, duration, dev)
    s = initial_states(cfg, x)
    _sync(dev)
    n_events = len(x.vio_times) + len(x.lidar_times)

    log(f"warm pass ({lanes} lanes)")
    launches0 = K.KERNEL_LAUNCHES
    out = lanes_pass(cfg, x, s, U.StageTimer())
    _sync(dev)
    launches = K.KERNEL_LAUNCHES - launches0
    if not bool(torch.isfinite(out.fused.poses).all()):
        raise RuntimeError("non-finite fused pose in the warm pass")

    log(f"timing {reps} passes")
    timer = U.StageTimer()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = lanes_pass(cfg, x, s, timer)
    _sync(dev)
    wall_b = (time.perf_counter() - t0) / reps
    launches_lanes = K.KERNEL_LAUNCHES - launches0
    events_per_s = lanes * n_events / wall_b

    log("single stream: lane 0 alone, warm, then timed")
    launches0 = K.KERNEL_LAUNCHES
    single_pass(cfg, x, s, U.StageTimer())
    _sync(dev)
    launches_1 = K.KERNEL_LAUNCHES - launches0
    timer_1 = U.StageTimer()
    t0 = time.perf_counter()
    for _ in range(reps):
        out_1 = single_pass(cfg, x, s, timer_1)
    _sync(dev)
    wall_1 = (time.perf_counter() - t0) / reps
    launches_single = K.KERNEL_LAUNCHES - launches0

    log(f"k-NN microbench at {knn_shape[0]}x{knn_shape[1]}")
    ms = lambda t: {k: v["mean_s"] * 1e3 for k, v in t.summary().items()}
    diag = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "rig": f"{rig.cam_w}x{rig.cam_h}@20Hz camera, 16x1800@10Hz lidar",
        "maps": {"corner": rig.corner_capacity, "surf": rig.surf_capacity,
                 "submap_corners": rig.submap_corners,
                 "submap_surfs": rig.submap_surfs},
        "duration_s": duration,
        "events_per_lane": n_events,
        "batch_distinct_sequences": lanes,
        "reps": reps,
        "wall_s_per_batched_pass": wall_b,
        "events_per_s": events_per_s,
        "realtime_factor_aggregate": lanes * duration / wall_b,
        "single_stream_wall_s": wall_1,
        "single_stream_events_per_s": n_events / wall_1,
        "realtime_factor_single_stream": duration / wall_1,
        "stages_ms_batched": ms(timer),
        "stages_ms_single": ms(timer_1),
        "knn_launches_per_pass": launches,
        "knn_launches_lanes": launches_lanes,
        "knn_launches_per_single_pass": launches_1,
        "knn_launches_single_stream": launches_single,
        "knn_kernel": knn_microbench(dev, knn_shape),
    }
    target = REALTIME_EVENTS_PER_S * TARGET_MULTIPLIER
    line = {"metric": "full_vil_events_per_s_per_chip",
            "value": round(events_per_s, 1), "unit": "events/s",
            "vs_baseline": round(events_per_s / target, 3)}
    return BenchResult(line, diag, x, out, out_1)


def main(lanes: int = BATCH, duration: float = DURATION, reps: int = REPS,
         device="cuda") -> BenchResult:
    """:func:`run`, with progress and the breakdown on stderr and the one
    JSON line on stdout."""
    t_start = time.perf_counter()

    def log(msg):
        print(f"[bench +{time.perf_counter() - t_start:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    res = run(lanes, duration, reps, device, log)
    print(json.dumps(res.diag, indent=2), file=sys.stderr, flush=True)
    print(json.dumps(res.line), flush=True)
    return res

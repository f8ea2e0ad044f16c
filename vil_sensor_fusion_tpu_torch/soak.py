"""Long-drive soak: the full VIL stack streamed over a drive in fixed-size
chunks, every stage's state carried from chunk to chunk, the way a live
deployment runs it. The port's counterpart of the repository's
``scripts/soak.py``, at the reference sensor rig by default (800×600 camera
at 20 Hz, 16×1800 sweeps at 10 Hz, 200 Hz IMU).

    python -m vil_sensor_fusion_tpu_torch.soak [--duration 60]
        [--chunk 10] [--checkpoint-test] [--cam 800x600] [--photometric]
        [--device cuda]

What it shows:

- map residency: the voxel maps fill to capacity with ``keep_radius``
  eviction while registration keeps converging;
- fixed-lag drift: bounded fused error over the whole drive;
- f32 time handling: stamps up to the drive's length, IMU windows opened at
  each chunk's start;
- checkpoint → resume: the states saved mid-drive and restored into a fresh
  template reproduce the uninterrupted run exactly (``--checkpoint-test``);
- sustained throughput: per chunk, the timed region is the device pipeline
  only (batched pyramids, batched detection with LiDAR depths, and
  :func:`estimator_chunk`: tracking → VIO → LiDAR odometry → gate →
  timeline → fixed-lag fusion), each ending in a device sync. Rendering
  the world and sampling the IMU are untimed.

Every per-chunk index (which sweep serves each frame's depths, which frame
primes each sweep's registration, the merged event order) is the same for
every chunk; :func:`chunk_indices` computes it once in numpy and moves it to
the device once. The summary is printed as JSON on stdout under the JAX
script's keys; progress, and the card's name and power limit, go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from . import _precision
from . import fusion as fu
from . import graph as G
from . import utils as U
from .core import lie
from .data import raycast as rc
from .data import synthetic as syn
from .degeneracy import gate as DG
from .frontends import lidar as L
from .frontends import vio as V
from .frontends.vio import frontend as F
from .frontends.vio import photometric as PH
from .fusion import engine as E
from .utils.tracing import block_until_ready as ready

VIO_HZ, LIDAR_HZ, IMU_HZ = 20.0, 10.0, 200.0
SWEEP_STRIDE = 4        # azimuth decimation of the depth association
IMU_BACK_MARGIN = 0.25  # s of IMU before each chunk's start


class SoakRig(NamedTuple):
    """The soak's configuration of every stage (scripts/soak.py:97-156)."""

    vio: V.VioConfig
    frontend: F.FrontendConfig
    lidar: L.LidarOdomConfig
    gate: DG.GateConfig
    fusion: fu.FusionConfig
    photometric: bool


def soak_rig(cam_w: int = 800, cam_h: int = 600, landmarks: int = 24,
             vio_use_odom_cov: bool = False, vio_twist_cov: bool = False,
             vio_cov: float = 0.3, lidar_cov: float = 0.05,
             gravity_update: bool = True, zuv_update: bool = True,
             lidar_anchor: bool = False, anchor_scale: float = 25.0,
             photometric: bool = False, dtype=torch.float32) -> SoakRig:
    """The carla camera (fov 100°) from 400 px wide, a scaled pinhole below;
    the EKF with 2 update iterations; 64 (32) candidates; two-stage LOAM with
    6 / 8 iterations, correspondences every 2nd, 3 Jacobi sweeps and the
    last fits' statistics; the normalised log-det gate (4.0, −6.0); a
    6-keyframe window. ``vio_use_odom_cov`` makes the EKF's pose covariance
    the VIO between noise, ``vio_twist_cov`` its twist covariance."""
    big_cam = cam_w >= 400
    cam = (V.camera.carla_camera(width=cam_w, height=cam_h) if big_cam else
           V.camera.Camera(fx=107.0 * cam_w / 160, fy=107.0 * cam_w / 160,
                           cx=cam_w / 2.0, cy=cam_h / 2.0, width=cam_w,
                           height=cam_h))
    pose_ic = tuple(float(v) for v in
                    F.forward_camera_extrinsics(dtype, device="cpu"))
    sensors = (
        fu.SensorSpec(name="vio", optimize_after_odom=True,
                      use_pose_covariance=vio_use_odom_cov,
                      use_odom_covariance=vio_twist_cov,
                      covariance_linear=vio_cov, covariance_angular=vio_cov,
                      max_time_skip=0.1),
        fu.SensorSpec(name="lidar", optimize_after_odom=False,
                      use_odom_covariance=False, covariance_linear=lidar_cov,
                      covariance_angular=lidar_cov, max_time_skip=0.2,
                      absolute_anchor=lidar_anchor,
                      anchor_cov_scale=anchor_scale))
    return SoakRig(
        vio=V.VioConfig(num_landmarks=landmarks, update_iters=2, cam=cam,
                        pose_ic=pose_ic, use_gravity_update=gravity_update,
                        use_zero_velocity_update=zuv_update,
                        use_photometric=photometric),
        frontend=F.FrontendConfig(cam=cam, n_candidates=64 if big_cam else 32,
                                  min_dist=24.0 if big_cam else 10.0,
                                  min_score=0.5),
        lidar=L.LidarOdomConfig(
            icp=L.IcpConfig(iters=6, degen_eigval=5.0, fit_every=2,
                            final_refresh=False, eig_sweeps=3),
            odom_icp=L.IcpConfig(iters=8, max_corr_dist=2.0,
                                 degen_eigval=5.0, fit_every=2,
                                 final_refresh=False, eig_sweeps=3),
            two_stage=True, undistort=True, guess_is_delta=True),
        gate=DG.GateConfig(rot_threshold=4.0, trans_threshold=-6.0,
                           normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
            sensors=sensors, max_imu_per_gap=32),
        photometric=photometric)


def soak_trajectory(speed: float = 4.0) -> syn.Trajectory:
    """The soak's drive: ``speed`` m/s along +x, a 2 m sinusoidal weave of
    period 8π s, 1.5 m up, yaw along the weave's tangent."""
    def pos_fn(t):
        return torch.stack([speed * t, 2.0 * torch.sin(0.25 * t),
                            1.5 + 0.0 * t])

    def rot_fn(t):
        yaw = torch.atan2(2.0 * 0.25 * torch.cos(0.25 * t),
                          torch.full_like(t, speed))
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t, yaw]))

    return syn.trajectory(pos_fn, rot_fn)


class ChunkIndex(NamedTuple):
    """The static per-chunk structure (scripts/soak.py:158-175): the same
    for every chunk of ``chunk`` seconds."""

    vio_rel: np.ndarray        # (Tv,) frame stamps from the chunk's start
    lidar_rel: np.ndarray      # (Tl,) sweep stamps from the chunk's start
    sw_idx: torch.Tensor       # (Tv,) the sweep giving each frame's depths
    guess_idx: torch.Tensor    # (Tl,) the frame priming each sweep
    order: torch.Tensor        # (Tv + Tl,) merged event order
    src: torch.Tensor          # (Tv + Tl,) int32 source of each event
    rel_sorted: torch.Tensor   # (Tv + Tl,) event stamps in the run dtype
    rel_sorted_np: np.ndarray  # (Tv + Tl,) the same in float64


def chunk_indices(chunk: float, dtype, device) -> ChunkIndex:
    Tv, Tl = int(chunk * VIO_HZ), int(chunk * LIDAR_HZ)
    vio_rel = (np.arange(Tv) + 1.0) / VIO_HZ
    lidar_rel = (np.arange(Tl) + 1.0) / LIDAR_HZ
    sw_idx = np.clip(np.searchsorted(lidar_rel, vio_rel + 1e-9) - 1, 0, None)
    guess_idx = np.clip(np.searchsorted(vio_rel, lidar_rel + 1e-9) - 1, 0,
                        None)
    all_rel = np.concatenate([vio_rel, lidar_rel])
    order = np.argsort(all_rel, kind="stable")
    src = np.concatenate([np.zeros(Tv, np.int32), np.ones(Tl, np.int32)])

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return ChunkIndex(vio_rel=vio_rel, lidar_rel=lidar_rel,
                      sw_idx=dev(sw_idx), guess_idx=dev(guess_idx),
                      order=dev(order), src=dev(src[order]),
                      rel_sorted=dev(all_rel[order], dtype),
                      rel_sorted_np=all_rel[order])


class ChunkOutput(NamedTuple):
    vio: V.VioOutput
    lidar: L.LidarOdomResult
    gate: DG.GateResult
    fused: fu.FusedOutput


def estimator_chunk(rig: SoakRig, idx: ChunkIndex, state: dict, py, cu, cs,
                    cd, prj, imu_w, sweeps: L.Sweep, t_off: torch.Tensor,
                    imu_t, imu_a, imu_g) -> tuple[dict, ChunkOutput]:
    """The sequential estimator over one chunk (scripts/soak.py:184-235):
    tracking (KLT and slots, or the photometric EKF, which is its own
    tracker) → VIO → VIO-delta LiDAR priors → two-stage LiDAR odometry →
    log-det gate → the static-order timeline → fixed-lag fusion. ``state``
    is the dict ``tracker, vio, lidar, engine, vio_ref`` (the VIO pose at
    the previous chunk's last sweep frame); ``t_off`` is the chunk's start
    in the run dtype. Returns the new state and the chunk's outputs."""
    with U.span("soak.estimator_chunk"):
        if rig.photometric:
            ts1 = state["tracker"]          # carried unchanged
            vs1, vio_out = PH.run(rig.vio, rig.frontend, state["vio"], py,
                                  cu, cs, cd, prj, imu_w)
        else:
            frames, ts1 = F.track_frames(rig.frontend, py, cu, cs, cd, prj,
                                         imu_w, rig.vio.num_landmarks,
                                         ts0=state["tracker"])
            vs1, vio_out = V.run(rig.vio, state["vio"], frames)
        vio_sel = vio_out.pose[idx.guess_idx]
        prev_sel = torch.cat([state["vio_ref"][None], vio_sel[:-1]], dim=0)
        guesses = lie.pose_between(prev_sel, vio_sel)
        ls1, lidar_out = L.odometry.run(rig.lidar, state["lidar"], sweeps,
                                        guesses)
        gres = DG.logdet_gate(lidar_out.hessian, rig.gate, lidar_out.n_corr)
        dtype, device = vio_out.pose.dtype, vio_out.pose.device
        Tv, E_ = vio_out.pose.shape[0], idx.order.shape[0]
        # The registration covariance over the sweep period squared: the
        # LiDAR's twist covariance (run_vil's stage 4).
        lidar_twist = lidar_out.cov / torch.as_tensor(
            (1.0 / LIDAR_HZ) ** 2, dtype=dtype, device=device)

        def merged(a, b):
            return torch.cat([a, b], dim=0)[idx.order]

        tl = E.Timeline(
            times=t_off + idx.rel_sorted, source=idx.src,
            odo_pose=merged(vio_out.pose, lidar_out.pose),
            odo_cov=merged(vio_out.cov, lidar_out.cov),
            keep=merged(torch.ones(Tv, dtype=dtype, device=device),
                        gres.keep),
            valid=torch.ones(E_, dtype=dtype, device=device),
            odo_twist_cov=merged(vio_out.twist_cov, lidar_twist))
        es1, fused = E.run(rig.fusion, state["engine"], tl, imu_t, imu_a,
                           imu_g)
        new_state = dict(tracker=ts1, vio=vs1, lidar=ls1, engine=es1,
                         vio_ref=vio_sel[-1])
    return new_state, ChunkOutput(vio_out, lidar_out, gres, fused)


def fresh_state(rig: SoakRig, traj: syn.Trajectory, dtype, device) -> dict:
    """Every stage's state at the drive's start (scripts/soak.py:244-260);
    also the template a checkpoint restores into."""
    t0 = torch.zeros((), dtype=dtype, device=device)
    pose0, vel0 = traj.pose_fn(t0), traj.vel_fn(t0)
    zeros6 = torch.zeros(6, dtype=dtype, device=device)
    vio0 = V.init(rig.vio, pose0, vel0, zeros6)
    if rig.photometric:
        vio0 = PH.init_photo(rig.vio, vio0)
    return dict(
        tracker=F.init_tracker(rig.frontend, rig.vio.num_landmarks, dtype,
                               device),
        vio=vio0,
        lidar=L.odometry.init(rig.lidar, dtype, pose0=pose0),
        engine=fu.init(rig.fusion, pose0, vel0, zeros6, t0 - 1e-3),
        vio_ref=pose0)


class ChunkInputs(NamedTuple):
    """One chunk's rendered sensor streams and ground truth."""

    images: torch.Tensor       # (Tv, H, W)
    pts_cam: torch.Tensor      # (Tv, P, 3) strided sweep points, camera frame
    sw_msk: torch.Tensor       # (Tv, P)
    sweeps: L.Sweep            # (Tl, R, A, ·)
    imu_w: tuple               # per-frame IMU windows
    imu: tuple                 # (times, accel, gyro) of the chunk's stream
    poses_v: torch.Tensor      # (Tv, 7) ground truth at the frames
    poses_l: torch.Tensor      # (Tl, 7) ground truth at the sweeps


def render_chunk(world: rc.World, traj: syn.Trajectory, rig: SoakRig,
                 idx: ChunkIndex, tc0: float, chunk: float, dtype,
                 device) -> ChunkInputs:
    """Render chunk ``[tc0, tc0 + chunk)`` (scripts/soak.py:267-303): the
    sweeps, the camera frames, each frame's strided sweep points in the
    camera frame, and the IMU stream from ``IMU_BACK_MARGIN`` s before the
    chunk with the per-frame windows opened at ``tc0``."""
    vio_times, lidar_times = tc0 + idx.vio_rel, tc0 + idx.lidar_rel
    pose_fn = torch.func.vmap(traj.pose_fn)
    poses_v = pose_fn(torch.as_tensor(vio_times, dtype=dtype, device=device))
    poses_l = pose_fn(torch.as_tensor(lidar_times, dtype=dtype,
                                      device=device))
    sweeps = rc.sweep_series(world, poses_l)
    pose_ic = torch.as_tensor(rig.vio.pose_ic, dtype=dtype, device=device)
    poses_cam = lie.pose_compose(poses_v, pose_ic)
    images = rc.render_camera_series(world, poses_cam, rig.vio.cam)

    Tl = poses_l.shape[0]
    sw_xyz = sweeps.xyz[:, :, ::SWEEP_STRIDE, :].reshape(Tl, -1, 3)[
        idx.sw_idx]
    sw_msk = sweeps.mask[:, :, ::SWEEP_STRIDE].reshape(Tl, -1)[idx.sw_idx]
    pose_cl = lie.pose_compose(lie.pose_inverse(poses_cam),
                               poses_l[idx.sw_idx])
    pts_cam = (lie.quat_rotate(lie.pose_quat(pose_cl)[:, None], sw_xyz)
               + lie.pose_trans(pose_cl)[:, None])

    # The chunk's IMU stream in the run dtype, as f32 arithmetic rounds it:
    # imu_t0 + k / imu_hz.
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    imu_t0 = max(0.0, tc0 - IMU_BACK_MARGIN)
    n_imu = int((chunk + 0.35) * IMU_HZ)
    imu_t = (np_dt.type(imu_t0)
             + np.arange(n_imu, dtype=np_dt) / np_dt.type(IMU_HZ))
    imu = syn.sample_imu(traj, torch.as_tensor(imu_t, device=device))
    imu_w = V.synthetic.imu_windows_for_frames(
        traj, vio_times, imu_hz=IMU_HZ, dtype=dtype, t_start=tc0,
        device=device)
    return ChunkInputs(images=images, pts_cam=pts_cam.to(dtype),
                       sw_msk=sw_msk.to(dtype), sweeps=sweeps, imu_w=imu_w,
                       imu=(imu.times, imu.accel.to(dtype),
                            imu.gyro.to(dtype)),
                       poses_v=poses_v, poses_l=poses_l)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a card that is not there raises
    (there is no CPU fallback), and a card present prints its name and
    power limit to stderr."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} runs on a CUDA card (--device cuda); "
                               "none is available")
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    return dev


def run_soak(duration=60.0, chunk=10.0, cam_w=800, cam_h=600, speed=4.0,
             landmarks=24, checkpoint_test=False, checkpoint_dir=None,
             verbose=True, dtype=None, vio_use_odom_cov=False,
             vio_twist_cov=False, vio_cov=0.3, lidar_cov=0.05,
             gravity_update=True, zuv_update=True, lidar_anchor=False,
             anchor_scale=25.0, photometric=False, device="cuda"):
    """Stream ``duration`` s (rounded up to whole chunks) in chunks of
    ``chunk`` s on ``device``. With ``checkpoint_test`` the state is saved
    after the first half of the chunks (into ``checkpoint_dir``, else a
    temporary directory), the drive continues, and the second half runs
    again from the checkpoint restored into :func:`fresh_state`;
    ``resume_max_delta`` is the largest difference of the engine's window
    poses between the two. Returns ``(summary, per-chunk metrics)``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the soak runs on a CUDA card (--device cuda); "
                           "none is available")
    _precision.require_full_f32()
    dtype = dtype or torch.float32
    t_wall0 = time.perf_counter()

    def log(msg):
        if verbose:
            print(f"[soak +{time.perf_counter() - t_wall0:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    if dev.type == "cuda":
        log(f"card: {card_line()}")
    # Ceil, so the whole span is simulated; every ratio below uses it.
    n_chunks = -int(-duration // chunk)
    simulated_s = n_chunks * chunk
    world = rc.road_world(length=speed * simulated_s, seed=0, dtype=dtype,
                          device=dev)
    traj = soak_trajectory(speed)
    rig = soak_rig(cam_w, cam_h, landmarks, vio_use_odom_cov, vio_twist_cov,
                   vio_cov, lidar_cov, gravity_update, zuv_update,
                   lidar_anchor, anchor_scale, photometric, dtype)
    idx = chunk_indices(chunk, dtype, dev)

    def run_chunks(state, k0, k1, collect):
        """Stream chunks [k0, k1); append their metrics to ``collect``."""
        for k in range(k0, k1):
            tc0 = k * chunk
            x = ready(render_chunk(world, traj, rig, idx, tc0, chunk, dtype,
                                   dev))

            t_c = time.perf_counter()
            py = ready(F.pyramids_batch(rig.frontend, x.images))
            t_pyr = time.perf_counter()
            cu, cs, cd, prj = ready(F.candidates_batch(
                rig.frontend, x.images, x.pts_cam, x.sw_msk))
            t_cand = time.perf_counter()
            state, out = ready(estimator_chunk(
                rig, idx, state, py, cu, cs, cd, prj, x.imu_w, x.sweeps,
                torch.as_tensor(tc0, dtype=dtype, device=dev), *x.imu))
            t_est = time.perf_counter()
            wall = t_est - t_c

            gt = torch.func.vmap(traj.pose_fn)(torch.as_tensor(
                tc0 + idx.rel_sorted_np, dtype=dtype, device=dev))
            host = lambda t: t.detach().cpu().numpy()  # noqa: E731
            fused = host(out.fused.poses)
            err = np.linalg.norm(fused[:, 4:7] - host(gt)[:, 4:7], axis=-1)
            verr = np.linalg.norm(host(out.vio.pose)[:, 4:7]
                                  - host(x.poses_v)[:, 4:7], axis=-1)
            lerr = np.linalg.norm(host(out.lidar.pose)[:, 4:7]
                                  - host(x.poses_l)[:, 4:7], axis=-1)
            m = dict(
                chunk=k, t0=tc0, wall_s=wall, wall_pyr=t_pyr - t_c,
                wall_cand=t_cand - t_pyr, wall_est=t_est - t_cand,
                err_mean=float(err.mean()), err_max=float(err.max()),
                vio_err_max=float(verr.max()),
                lidar_err_max=float(lerr.max()),
                map_corner=float(state["lidar"].corner_map.mask.sum()),
                map_surf=float(state["lidar"].surf_map.mask.sum()),
                keep=float(out.gate.keep.mean()),
                healthy=float(out.fused.healthy.mean()),
                last_pose=fused[-1])
            collect.append(m)
            log(f"chunk {k + 1}/{n_chunks}: fused err mean {err.mean():.2f}"
                f" max {err.max():.2f} m (vio {verr.max():.2f}, lidar "
                f"{lerr.max():.2f}), map {m['map_corner']:.0f}/"
                f"{m['map_surf']:.0f}, keep {m['keep']:.2f}, healthy "
                f"{m['healthy']:.2f}, {wall:.2f}s wall ({chunk / wall:.2f}x "
                f"RT; pyr {t_pyr - t_c:.2f} cand {t_cand - t_pyr:.2f} est "
                f"{t_est - t_cand:.2f})")
        return state

    state = fresh_state(rig, traj, dtype, dev)
    metrics: list = []
    if checkpoint_test:
        k_half = n_chunks // 2
        state = run_chunks(state, 0, k_half, metrics)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(checkpoint_dir or tmp, "soak.npz")
            U.save(path, state)
            log(f"checkpoint saved at chunk {k_half}")
            # The uninterrupted continuation, then the resume from disk into
            # a fresh template.
            state_cont = run_chunks(state, k_half, n_chunks, list(metrics))
            restored = U.restore(path, fresh_state(rig, traj, dtype, dev))
        state_res = run_chunks(restored, k_half, n_chunks, metrics)
        a = state_cont["engine"].smoother.states.poses
        b = state_res["engine"].smoother.states.poses
        resume_err = float((a - b).abs().max())
        log(f"resume equivalence: max |Δpose| = {resume_err:.2e}")
    else:
        state = run_chunks(state, 0, n_chunks, metrics)
        resume_err = None

    errs = [m["err_max"] for m in metrics]
    walls = [m["wall_s"] for m in metrics]
    summary = dict(
        duration_s=simulated_s, chunks=len(metrics),
        cam=f"{cam_w}x{cam_h}", landmarks=landmarks,
        vio_mode="photometric" if photometric else "geometric",
        distance_m=speed * simulated_s,
        err_mean_m=float(np.mean([m["err_mean"] for m in metrics])),
        err_max_m=float(np.max(errs)),
        err_max_last_chunk_m=float(errs[-1]),
        ate_pct_of_distance=float(np.max(errs) / (speed * simulated_s) * 100),
        map_corner_final=metrics[-1]["map_corner"],
        map_surf_final=metrics[-1]["map_surf"],
        keep_mean=float(np.mean([m["keep"] for m in metrics])),
        healthy_mean=float(np.mean([m["healthy"] for m in metrics])),
        wall_s_total=float(np.sum(walls)),
        realtime_factor=float(simulated_s / np.sum(walls)),
        # Without the first chunk, which carries one-time warm-up: the
        # sustained per-chunk rate of a long-running deployment.
        realtime_factor_steady=float(
            (simulated_s - chunk) / np.sum(walls[1:]))
        if len(walls) > 1 else None,
        stages_s_mean=dict(
            pyr=float(np.mean([m["wall_pyr"] for m in metrics])),
            cand=float(np.mean([m["wall_cand"] for m in metrics])),
            est=float(np.mean([m["wall_est"] for m in metrics]))),
        # Per-chunk max error: is the drift still growing at the end?
        per_chunk_err_max_m=[float(e) for e in errs],
        resume_max_delta=resume_err,
        platform="gpu" if dev.type == "cuda" else dev.type,
    )
    return summary, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vil_sensor_fusion_tpu_torch.soak",
        description="Stream a long drive through the full VIL stack in "
                    "chunks with every stage's state carried.")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--chunk", type=float, default=10.0)
    ap.add_argument("--cam", default="800x600",
                    help="camera resolution WxH (reference rig: 800x600)")
    ap.add_argument("--landmarks", type=int, default=24)
    ap.add_argument("--checkpoint-test", action="store_true")
    ap.add_argument("--vio-odom-cov", action="store_true",
                    help="use the EKF's own pose covariance as the VIO "
                         "between-factor noise")
    ap.add_argument("--vio-twist-cov", action="store_true",
                    help="the VIO twist covariance copied verbatim into the "
                         "between noise (the reference's "
                         "use_odom_covariance)")
    ap.add_argument("--vio-cov", type=float, default=0.3)
    ap.add_argument("--lidar-cov", type=float, default=0.05)
    ap.add_argument("--no-gravity", action="store_true",
                    help="disable the EKF gravity/attitude pseudo-update")
    ap.add_argument("--no-zuv", action="store_true",
                    help="disable the EKF zero-velocity update")
    ap.add_argument("--photometric", action="store_true",
                    help="the direct photometric VIO instead of the "
                         "geometric KLT path")
    ap.add_argument("--lidar-anchor", action="store_true",
                    help="absolute map-anchored unary factors from the "
                         "scan-to-map stream")
    ap.add_argument("--anchor-scale", type=float, default=25.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    cam_w, cam_h = map(int, args.cam.split("x"))
    summary, _ = run_soak(duration=args.duration, chunk=args.chunk,
                          cam_w=cam_w, cam_h=cam_h,
                          landmarks=args.landmarks,
                          checkpoint_test=args.checkpoint_test,
                          vio_use_odom_cov=args.vio_odom_cov,
                          vio_twist_cov=args.vio_twist_cov,
                          vio_cov=args.vio_cov, lidar_cov=args.lidar_cov,
                          gravity_update=not args.no_gravity,
                          zuv_update=not args.no_zuv,
                          lidar_anchor=args.lidar_anchor,
                          anchor_scale=args.anchor_scale,
                          photometric=args.photometric, device=args.device)
    print(json.dumps(summary, indent=2), flush=True)
    return summary


if __name__ == "__main__":
    main()

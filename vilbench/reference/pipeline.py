"""The two estimator paths the benchmark times, on the frozen copy ``vil``.

Copied from the port at commit 9df89905ef8a8933d2d3095c028767cc15a794cf:
``bench.py`` (``Rig``, ``bench_config``, ``build_inputs``,
``initial_states``, ``delta_guesses``, ``timeline``, ``lanes_pass``) and
``soak.py`` (``soak_rig``, ``soak_trajectory``, ``chunk_indices``,
``estimator_chunk`` in its geometric mode, ``fresh_state``,
``render_chunk``). What was changed: imports point at the copy; the stage
timer is gone; ``bench_config`` writes out the default sensor noise of
``fusion/vil.py:VilConfig``, which the copy leaves out; ``build_inputs``
takes the world's kind; the photometric branch of the soak is left out.
The benchmark also makes its inputs here (``build_inputs``,
``render_chunk``), so that both sides get the same tensors from code that
no later change to the port moves.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .vil import _tree
from .vil import fusion as fu
from .vil import graph as G
from .vil.core import lie
from .vil.data import raycast as rc
from .vil.data import scenarios
from .vil.data import synthetic as syn
from .vil.degeneracy import gate as DG
from .vil.frontends import lidar as L
from .vil.frontends import vio as V
from .vil.frontends.lidar import voxelmap as vm
from .vil.frontends.vio import frontend as F
from .vil.fusion import engine as E

tree_map = _tree.tree_map
tree_leaves = _tree.tree_leaves


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (``on``) or full float32 inside the
    block; the switches are restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- bench.py

SWEEP_STRIDE = 4        # azimuth decimation of the depth association


class Rig(NamedTuple):
    cam_w: int = 800
    cam_h: int = 600
    corner_capacity: int = 24576
    surf_capacity: int = 49152
    submap_corners: int = 2048
    submap_surfs: int = 4096


class BenchConfig(NamedTuple):
    vio: V.VioConfig
    frontend: F.FrontendConfig
    lidar: L.LidarOdomConfig
    gate: DG.GateConfig
    fusion: fu.FusionConfig


# fusion/vil.py:VilConfig's sensors (rovio covariance 0.2, loam 0.1).
VIL_SENSORS = (
    E.SensorSpec(name="vio", optimize_after_odom=True,
                 use_odom_covariance=False, covariance_linear=0.2,
                 covariance_angular=0.2, max_time_skip=0.1),
    E.SensorSpec(name="lidar", optimize_after_odom=False,
                 use_odom_covariance=False, covariance_linear=0.1,
                 covariance_angular=0.1, max_time_skip=0.2),
)


def bench_config(rig: Rig = Rig(), n_slots: int = 24) -> BenchConfig:
    cam = V.camera.carla_camera(width=rig.cam_w, height=rig.cam_h)
    pose_ic = tuple(float(v) for v in
                    F.forward_camera_extrinsics(torch.float64, device="cpu"))
    return BenchConfig(
        vio=V.VioConfig(num_landmarks=n_slots, update_iters=2, cam=cam,
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
            sensors=VIL_SENSORS, max_imu_per_gap=32))


class BenchInputs(NamedTuple):
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
                 seed: int = 0, world: str = "town") -> BenchInputs:
    f32 = torch.float32
    t0 = torch.zeros((), dtype=f32, device=device)
    scs, rendered = [], []
    for b in range(lanes):
        sc = scenarios.build(world, duration=duration, vio_cfg=cfg.vio,
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
    idx = torch.as_tensor(guess_idx, device=vio_poses.device)
    sel = vio_poses[..., idx, :]
    prev = torch.cat([pose0[..., None, :], sel[..., :-1, :]], dim=-2)
    return lie.pose_between(prev, sel)


def timeline(x: BenchInputs, vio_pose, vio_cov, lidar_pose, lidar_cov,
             lidar_keep) -> fu.Timeline:
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


def lanes_pass(cfg: BenchConfig, x: BenchInputs, s: States) -> PassOutput:
    fe = cfg.frontend
    py = F.pyramids_batch(fe, x.images)
    cand = F.candidates_batch(fe, x.images, x.cam_points, x.cam_point_valid)
    frames = F.track_frames_lanes(fe, py, *cand, x.imu_windows,
                                  cfg.vio.num_landmarks)
    _, vio = V.pipeline.run_lanes(cfg.vio, s.vio, frames)
    guesses = delta_guesses(vio.pose, x.pose0, x.guess_idx)
    _, lidar = L.odometry.run_lanes(cfg.lidar, s.lidar, x.sweeps, guesses)
    gate = DG.logdet_gate(lidar.hessian, cfg.gate, lidar.n_corr)
    tl = timeline(x, vio.pose, vio.cov, lidar.pose, lidar.cov, gate.keep)
    _, fused = E.run_lanes(cfg.fusion, s.engine, tl, x.imu_times,
                           x.imu_accel, x.imu_gyro)
    return PassOutput(frames, vio, lidar, gate, fused)


# ----------------------------------------------------------------- soak.py

VIO_HZ, LIDAR_HZ, IMU_HZ = 20.0, 10.0, 200.0
IMU_BACK_MARGIN = 0.25  # s of IMU before each chunk's start


class SoakRig(NamedTuple):
    vio: V.VioConfig
    frontend: F.FrontendConfig
    lidar: L.LidarOdomConfig
    gate: DG.GateConfig
    fusion: fu.FusionConfig


def soak_rig(cam_w: int = 800, cam_h: int = 600, landmarks: int = 24,
             vio_cov: float = 0.3, lidar_cov: float = 0.05,
             dtype=torch.float32) -> SoakRig:
    """The soak's rig (scripts/soak.py:97-156) with the port's defaults for
    every switch the benchmark does not set."""
    big_cam = cam_w >= 400
    cam = (V.camera.carla_camera(width=cam_w, height=cam_h) if big_cam else
           V.camera.Camera(fx=107.0 * cam_w / 160, fy=107.0 * cam_w / 160,
                           cx=cam_w / 2.0, cy=cam_h / 2.0, width=cam_w,
                           height=cam_h))
    pose_ic = tuple(float(v) for v in
                    F.forward_camera_extrinsics(dtype, device="cpu"))
    sensors = (
        fu.SensorSpec(name="vio", optimize_after_odom=True,
                      use_pose_covariance=False, use_odom_covariance=False,
                      covariance_linear=vio_cov, covariance_angular=vio_cov,
                      max_time_skip=0.1),
        fu.SensorSpec(name="lidar", optimize_after_odom=False,
                      use_odom_covariance=False, covariance_linear=lidar_cov,
                      covariance_angular=lidar_cov, max_time_skip=0.2,
                      absolute_anchor=False, anchor_cov_scale=25.0))
    lcfg = L.LidarOdomConfig(
        icp=L.IcpConfig(iters=6, degen_eigval=5.0, fit_every=2,
                        final_refresh=False, eig_sweeps=3),
        odom_icp=L.IcpConfig(iters=8, max_corr_dist=2.0, degen_eigval=5.0,
                             fit_every=2, final_refresh=False, eig_sweeps=3),
        two_stage=True, undistort=True, guess_is_delta=True)
    return SoakRig(
        vio=V.VioConfig(num_landmarks=landmarks, update_iters=2, cam=cam,
                        pose_ic=pose_ic, use_gravity_update=True,
                        use_zero_velocity_update=True,
                        use_photometric=False),
        frontend=F.FrontendConfig(cam=cam, n_candidates=64 if big_cam else 32,
                                  min_dist=24.0 if big_cam else 10.0,
                                  min_score=0.5),
        lidar=lcfg,
        gate=DG.GateConfig(rot_threshold=4.0, trans_threshold=-6.0,
                           normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
            sensors=sensors, max_imu_per_gap=32))


def soak_trajectory(speed: float = 4.0) -> syn.Trajectory:
    def pos_fn(t):
        return torch.stack([speed * t, 2.0 * torch.sin(0.25 * t),
                            1.5 + 0.0 * t])

    def rot_fn(t):
        yaw = torch.atan2(2.0 * 0.25 * torch.cos(0.25 * t),
                          torch.full_like(t, speed))
        return lie.so3_exp(torch.stack([0.0 * t, 0.0 * t, yaw]))

    return syn.trajectory(pos_fn, rot_fn)


class ChunkIndex(NamedTuple):
    vio_rel: np.ndarray
    lidar_rel: np.ndarray
    sw_idx: torch.Tensor
    guess_idx: torch.Tensor
    order: torch.Tensor
    src: torch.Tensor
    rel_sorted: torch.Tensor
    rel_sorted_np: np.ndarray


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
    frames, ts1 = F.track_frames(rig.frontend, py, cu, cs, cd, prj, imu_w,
                                 rig.vio.num_landmarks, ts0=state["tracker"])
    vs1, vio_out = V.run(rig.vio, state["vio"], frames)
    vio_sel = vio_out.pose[idx.guess_idx]
    prev_sel = torch.cat([state["vio_ref"][None], vio_sel[:-1]], dim=0)
    guesses = lie.pose_between(prev_sel, vio_sel)
    ls1, lidar_out = L.odometry.run(rig.lidar, state["lidar"], sweeps,
                                    guesses)
    gres = DG.logdet_gate(lidar_out.hessian, rig.gate, lidar_out.n_corr)
    dtype, device = vio_out.pose.dtype, vio_out.pose.device
    Tv, E_ = vio_out.pose.shape[0], idx.order.shape[0]
    lidar_twist = lidar_out.cov / torch.as_tensor((1.0 / LIDAR_HZ) ** 2,
                                                  dtype=dtype, device=device)

    def merged(a, b):
        return torch.cat([a, b], dim=0)[idx.order]

    tl = E.Timeline(
        times=t_off + idx.rel_sorted, source=idx.src,
        odo_pose=merged(vio_out.pose, lidar_out.pose),
        odo_cov=merged(vio_out.cov, lidar_out.cov),
        keep=merged(torch.ones(Tv, dtype=dtype, device=device), gres.keep),
        valid=torch.ones(E_, dtype=dtype, device=device),
        odo_twist_cov=merged(vio_out.twist_cov, lidar_twist))
    es1, fused = E.run(rig.fusion, state["engine"], tl, imu_t, imu_a, imu_g)
    new_state = dict(tracker=ts1, vio=vs1, lidar=ls1, engine=es1,
                     vio_ref=vio_sel[-1])
    return new_state, ChunkOutput(vio_out, lidar_out, gres, fused)


def fresh_state(rig: SoakRig, traj: syn.Trajectory, dtype, device) -> dict:
    t0 = torch.zeros((), dtype=dtype, device=device)
    pose0, vel0 = traj.pose_fn(t0), traj.vel_fn(t0)
    zeros6 = torch.zeros(6, dtype=dtype, device=device)
    return dict(
        tracker=F.init_tracker(rig.frontend, rig.vio.num_landmarks, dtype,
                               device),
        vio=V.init(rig.vio, pose0, vel0, zeros6),
        lidar=L.odometry.init(rig.lidar, dtype, pose0=pose0),
        engine=fu.init(rig.fusion, pose0, vel0, zeros6, t0 - 1e-3),
        vio_ref=pose0)


class ChunkInputs(NamedTuple):
    images: torch.Tensor       # (Tv, H, W)
    pts_cam: torch.Tensor      # (Tv, P, 3)
    sw_msk: torch.Tensor       # (Tv, P)
    sweeps: L.Sweep            # (Tl, R, A, ·)
    imu_w: tuple               # per-frame IMU windows
    imu: tuple                 # (times, accel, gyro)
    poses_v: torch.Tensor      # (Tv, 7)
    poses_l: torch.Tensor      # (Tl, 7)


def render_chunk(world: rc.World, traj: syn.Trajectory, rig: SoakRig,
                 idx: ChunkIndex, tc0: float, chunk: float, dtype,
                 device) -> ChunkInputs:
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

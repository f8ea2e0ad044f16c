"""The degeneracy experiment the benchmark times, on the frozen copy ``vil``:
a stretch of the tunnel drive, ``run_vil``'s composition over it, and
``run_scenario``'s scoring.

Copied from the port at commit fca7b19a59a3dab35f7d3f7ef86d8175a04d0386:
``fusion/vil.py`` (``VilConfig``; ``run_vil``, lines 88-179, in their order
and with their registration guesses) and ``eval/experiments.py``
(``experiment_config`` at the ``ExperimentSpec`` defaults, ``METRIC_NAMES``,
the scoring of ``run_scenario``). What was changed:

- ``run_vil`` keeps the geometric VIO only: the photometric branch and the
  model-parallel ``mesh`` are left out, as the copy has neither;
- ``convert.to_torch`` of the merged timeline is written out for the one
  tree it takes here (:func:`_timeline_to`);
- ``experiment_config`` takes the spec's knobs as arguments and the map
  and submap sizes from the caller, whose defaults are the port's;
- :func:`run_scenario` returns what the benchmark compares (poses, the
  Hessian and ``n_corr`` series, the dists, the flags, the scores) and
  leaves out the errors against ground truth (``eval/diagnostics``), which
  decide nothing here;
- no program spans or counters.

:func:`tunnel_stretch` makes the inputs of both sides, as
``pipeline.build_inputs`` does for the lanes: ``data/scenarios.build``'s
tunnel drive of ``DRIVE_S`` seconds (its world, trajectory, labels and
rates unchanged), sampled over ``[start_s, start_s + duration_s]`` only
and put on the stretch's own clock, which starts at 0 at ``start_s``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from .vil import _tree
from .vil import fusion as fu
from .vil import graph as G
from .vil.core import lie
from .vil.data import raycast as rc
from .vil.data import scenarios
from .vil.data import synthetic as syn
from .vil.degeneracy import gate as DG
from .vil.degeneracy import metrics as M
from .vil.frontends import lidar as L
from .vil.frontends import vio as V
from .vil.frontends.lidar import voxelmap as vm
from .pipeline import VIL_SENSORS

KIND = "tunnel"
DRIVE_S = 60.0                              # default_grid's duration
VIO_HZ, LIDAR_HZ, IMU_HZ = 20.0, 10.0, 200.0   # scenarios.build's rates

# eval/experiments.py:METRIC_NAMES.
METRIC_NAMES = ("d_opt", "a_opt", "e_opt", "condition_number",
                "differential_entropy", "norm_frobenius",
                "d_opt_ratio", "e_opt_ratio",
                "jensen_bregman", "kullback_leibler_0cov")
AXES = ("tx", "ty", "tz", "rx", "ry", "rz")


class VilConfig(NamedTuple):
    vio: V.VioConfig
    lidar: L.LidarOdomConfig
    gate: DG.GateConfig
    fusion: fu.FusionConfig


def experiment_config(icp_iters: int = 6, degen_eigval: float = 5.0,
                      trans_threshold: float = -6.0,
                      rot_threshold: float = 4.0,
                      corner_capacity: int = 32768,
                      surf_capacity: int = 65536, submap_corners: int = 4096,
                      submap_surfs: int = 8192) -> VilConfig:
    """``eval/experiments.experiment_config`` of a spec with every switch
    on (two-stage LOAM, undistortion, ``emit_dists``), at the given maps."""
    return VilConfig(
        vio=V.VioConfig(num_landmarks=24, update_iters=2),
        lidar=L.LidarOdomConfig(
            icp=L.IcpConfig(iters=icp_iters, degen_eigval=degen_eigval),
            two_stage=True, undistort=True, emit_dists=True,
            guess_is_delta=True,
            corner_map=vm.VoxelMapConfig(capacity=corner_capacity, leaf=0.2),
            surf_map=vm.VoxelMapConfig(capacity=surf_capacity, leaf=0.4),
            submap_corners=submap_corners, submap_surfs=submap_surfs),
        gate=DG.GateConfig(rot_threshold=rot_threshold,
                           trans_threshold=trans_threshold,
                           normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12,
                                      gn_iters=4),
            sensors=VIL_SENSORS, max_imu_per_gap=32))


# ------------------------------------------------------------- the inputs

def _shifted(traj: syn.Trajectory, start_s: float) -> syn.Trajectory:
    """``traj`` on a clock that reads 0 at ``start_s``: each function at
    ``t`` is the drive's at ``start_s + t``, the sum taken in float64 (the
    trajectory's own precision)."""
    def at(fn):
        def f(t):
            return fn(t.to(torch.float64) + start_s).to(t.dtype)
        return f

    return syn.Trajectory(*(at(fn) for fn in traj))


def tunnel_stretch(seed: int, start_s: float, duration_s: float, device,
                   dtype=torch.float32) -> scenarios.VilScenario:
    """``scenarios.build("tunnel", duration=DRIVE_S, seed=seed,
    distort_sweeps=True)`` with the experiment's VIO, from drive time
    ``start_s`` for ``duration_s`` seconds, on the stretch's clock.

    The world, the trajectory and the labelled windows are those of the
    whole drive (the windows shifted by ``-start_s``). The IMU stream, the
    VIO frames' IMU windows, the frame and sweep times, the
    motion-distorted sweeps and the ground truth are ``build``'s sampling
    of a drive of ``duration_s`` on the shifted trajectory. The synthetic
    landmarks follow ``build``'s rule over the stretch: ``max(400, 400 ·
    (span / 2·extent + 1))`` of them, their x uniform over the stretch's
    road ± extent, from the same seeds."""
    world, traj, windows, speed, extent, height = scenarios._kind(
        KIND, DRIVE_S, seed, dtype, device)
    traj = _shifted(traj, start_s)
    vio_cfg = experiment_config().vio

    imu_t = (torch.arange(int(duration_s * IMU_HZ) + 20, dtype=dtype,
                          device=device) / IMU_HZ)
    imu = syn.sample_imu(traj, imu_t)

    def poses_at(times):
        return vmap(traj.pose_fn)(torch.as_tensor(times, dtype=dtype,
                                                  device=device))

    vio_times = (np.arange(int(duration_s * VIO_HZ)) + 1.0) / VIO_HZ
    poses_vio = poses_at(vio_times)
    imu_w = V.synthetic.imu_windows_for_frames(
        traj, vio_times, imu_hz=IMU_HZ, dtype=dtype, device=device)
    lidar_times = (np.arange(int(duration_s * LIDAR_HZ)) + 1.0) / LIDAR_HZ
    poses_lidar = poses_at(lidar_times)
    poses_start = poses_at(lidar_times - 1.0 / LIDAR_HZ)
    sw = [rc.raycast_motion(world, ps, pe)
          for ps, pe in zip(poses_start, poses_lidar)]
    sweeps = L.Sweep(*(torch.stack(f, dim=0) for f in zip(*sw)))

    span = speed * duration_s
    x_start = speed * start_s
    n_lms = max(400, int(400 * (span / (2.0 * extent) + 1.0)))
    lms = V.synthetic.landmark_field(n_lms, seed=seed + 1, extent=extent,
                                     height=height)
    lms[:, 0] = np.random.default_rng(seed + 3).uniform(
        x_start - extent, x_start + span + extent, n_lms)
    frames = V.synthetic.make_frames(
        vio_cfg, poses_vio.cpu().numpy(), imu_w, lms, pixel_noise=0.5,
        depth_noise=0.05, seed=seed + 2)
    frames = _tree.tree_map(lambda x: x.to(dtype), frames)
    ratio = VIO_HZ / LIDAR_HZ
    guess_idx = (np.round((np.arange(len(lidar_times)) + 1) * ratio) - 1
                 ).astype(np.int64)
    return scenarios.VilScenario(
        traj=traj, world=world,
        imu_times=imu.times, imu_accel=imu.accel, imu_gyro=imu.gyro,
        vio_times=vio_times, vio_frames=frames,
        lidar_times=lidar_times, sweeps=sweeps, lidar_guess_idx=guess_idx,
        gt_vio_poses=poses_vio.cpu().numpy(),
        gt_lidar_poses=poses_lidar.cpu().numpy(),
        degen_windows=tuple((a - start_s, b - start_s, k)
                            for a, b, k in windows))


# ------------------------------------------------------- the composition

def _timeline_to(tl: fu.Timeline, device, dtype) -> fu.Timeline:
    """``convert.to_torch`` of a merged (numpy) timeline: floating leaves
    in ``dtype``, the source ids as they are."""
    def leaf(x):
        t = torch.as_tensor(np.array(x), device=device)
        return t.to(dtype) if t.is_floating_point() else t

    return fu.Timeline(*(leaf(x) for x in tl))


def run_vil(cfg: VilConfig, imu_times, imu_accel, imu_gyro,
            vio_times: np.ndarray, vio_frames, vio_state,
            lidar_times: np.ndarray, sweeps, lidar_state,
            lidar_guess_from_vio_idx: np.ndarray, engine_state):
    """``fusion/vil.py:run_vil`` with the VIO's poses as the registration
    priors: VIO, LiDAR odometry, the log-det gate, the host-merged
    timeline, the fusion engine. Returns ``(vio, lidar, gate, timeline,
    fused)``."""
    _, vio_out = V.run(cfg.vio, vio_state, vio_frames)
    sel_idx = torch.as_tensor(np.asarray(lidar_guess_from_vio_idx),
                              device=vio_out.pose.device)
    vio_sel = vio_out.pose[sel_idx]
    prev = torch.cat([vio_state.pose[None], vio_sel[:-1]], dim=0)
    guesses = lie.pose_between(prev, vio_sel)
    _, lidar_out = L.odometry.run(cfg.lidar, lidar_state, sweeps, guesses)
    gate_res = DG.logdet_gate(lidar_out.hessian, cfg.gate,
                              n_corr=lidar_out.n_corr)

    poses = engine_state.smoother.states.poses
    dtype, device = poses.dtype, poses.device
    lt = np.asarray(lidar_times)
    dt_l = float(np.median(np.diff(lt))) if len(lt) > 1 else 0.1
    lidar_cov = lidar_out.cov.cpu().numpy()
    tl = fu.merge_timeline([
        (np.asarray(vio_times), vio_out.pose.cpu().numpy(),
         vio_out.cov.cpu().numpy(), np.ones(len(vio_times)),
         vio_out.twist_cov.cpu().numpy()),
        (lt, lidar_out.pose.cpu().numpy(), lidar_cov,
         gate_res.keep.cpu().numpy(), lidar_cov / max(dt_l, 1e-3) ** 2),
    ])
    tl = _timeline_to(tl, device, dtype)
    _, fused = fu.run(cfg.fusion, engine_state, tl, imu_times.to(dtype),
                      imu_accel.to(dtype), imu_gyro.to(dtype))
    return vio_out, lidar_out, gate_res, tl, fused


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def run_scenario(cfg: VilConfig, sc: scenarios.VilScenario) -> dict:
    """``eval/experiments.run_scenario``'s run and scoring from fresh states
    at the scenario's time 0: the metric scores of the Hessian series
    (translation and rotation), the normalised and raw gate log-dets and
    the six dist slopes. Returns, in numpy, the run's VIO, LiDAR and fused
    poses, the Hessian, ``n_corr``, dists and frozen-direction series, the
    gate's ``keep``, the fused ``healthy`` / ``solved`` flags and the
    scores, under the port's result keys."""
    dtype, dev = sc.sweeps.xyz.dtype, sc.sweeps.xyz.device
    t0 = torch.zeros((), dtype=dtype, device=dev)
    pose0, vel0 = sc.traj.pose_fn(t0), sc.traj.vel_fn(t0)
    zeros6 = torch.zeros(6, dtype=dtype, device=dev)
    vio, lidar, gate, _, fused = run_vil(
        cfg, sc.imu_times, sc.imu_accel, sc.imu_gyro,
        np.asarray(sc.vio_times), sc.vio_frames,
        V.init(cfg.vio, pose0, vel0, zeros6),
        np.asarray(sc.lidar_times), sc.sweeps,
        L.odometry.init(cfg.lidar, dtype, pose0=pose0),
        lidar_guess_from_vio_idx=np.asarray(sc.lidar_guess_idx),
        engine_state=fu.init(cfg.fusion, pose0, vel0, zeros6, t0))

    hessian = lidar.hessian
    series = DG.score_series(METRIC_NAMES, hessian)
    scores = {n: s.score_trans for n, s in series.items()}
    scores.update({f"{n}_rot": s.score_rot for n, s in series.items()})
    scores["gate_trans_logdet"] = gate.trans_d_opt
    scores["gate_rot_logdet"] = gate.rot_d_opt
    raw = DG.logdet_gate(hessian, DG.GateConfig(normalize_per_corr=False))
    scores["gate_trans_logdet_raw"] = raw.trans_d_opt
    scores["gate_rot_logdet_raw"] = raw.rot_d_opt
    d = lidar.dists
    slopes = M.dist_slopes_6dof(d.dists, d.shift_trans[0], d.shift_rot[0])
    for i, ax in enumerate(AXES):
        scores[f"dist_slope_{ax}"] = slopes[:, i]
    return {
        "vio_poses": _np(vio.pose),
        "lidar_poses": _np(lidar.pose),
        "fused_poses": _np(fused.poses),
        "hessian": _np(hessian),
        "n_corr": _np(lidar.n_corr),
        "dists": _np(d.dists),
        "icp_degenerate": _np(lidar.degenerate),
        "gate_keep": _np(gate.keep),
        "fused_healthy": _np(fused.healthy),
        "fused_solved": _np(fused.solved),
        "scores": {k: _np(v) for k, v in scores.items()},
    }

"""The port's slice as a whole against the JAX package: LiDAR odometry →
log-det gate → fusion engine over a short town drive, on identical numpy
inputs (sweeps raycast by the JAX package, a noisy VIO stream, the IMU
stream), in float64.

The JAX side composes stages 2-4 exactly as ``fusion/vil.py:run_vil``
does; it does not call JAX ``run_vil``, which would compile the VIO EKF
for stage 1. The port takes the same VIO stream through its ``run_vil``.

Tolerances: f64 on both sides and the same algorithm, so the LiDAR poses
agree to round-off (1e-7 m), the gate decisions exactly, and the fused
poses to 1e-7. Also here: importing the whole port loads no JAX."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu import graph as JG
from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import raycast as JR
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.data import synthetic as JS
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JV
from vil_sensor_fusion_tpu.fusion import vil as JVIL
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.fusion import vil as TVIL

DT = jnp.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    """The bench's operating point at narrow sizes: maps 4096/8192,
    submaps 512/1024, smoother window 4."""
    lidar = JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                          final_refresh=False, eig_sweeps=3),
        odom_icp=JLi.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                               fit_every=4, final_refresh=False,
                               eig_sweeps=3),
        corner_map=JV.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=JV.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024,
        two_stage=True, undistort=True, guess_is_delta=True)
    return JVIL.VilConfig(
        lidar=lidar,
        gate=JDG.GateConfig(4.0, -6.0, normalize_per_corr=True),
        fusion=JFU.FusionConfig(
            smoother=JG.SmootherConfig(window=4, between_slots=8,
                                       gn_iters=3),
            sensors=JVIL.VilConfig().fusion.sensors, max_imu_per_gap=32))


def _drive(duration=0.5):
    """Town drive: JAX-raycast sweeps, IMU, and a VIO stream with numpy
    pose noise, all as numpy float64."""
    traj = JSC._town_traj()
    world = JR.town_world(n_boxes=28, seed=0, dtype=DT)
    imu_t = jnp.arange(int(duration * 200) + 20, dtype=DT) / 200.0
    imu = jax.jit(lambda t: JS.sample_imu(traj, t))(imu_t)
    vio_times = (np.arange(int(duration * 20)) + 1.0) / 20.0
    lidar_times = (np.arange(int(duration * 10)) + 1.0) / 10.0
    sweeps = jax.jit(lambda w, t: JR.sweep_series(
        w, jax.vmap(traj.pose_fn)(t)))(world, jnp.asarray(lidar_times, DT))
    odo = JS.sample_odometry(traj, jnp.asarray(vio_times, DT), 0.02, 0.002)
    rng = np.random.default_rng(11)
    xi = np.concatenate([0.02 * rng.standard_normal((len(vio_times), 3)),
                         0.002 * rng.standard_normal((len(vio_times), 3))],
                        axis=1)
    vio_pose = jax.vmap(JL.pose_retract)(odo.poses, jnp.asarray(xi))
    t0 = jnp.zeros((), DT)
    return dict(
        imu=(np.asarray(imu.times), np.asarray(imu.accel),
             np.asarray(imu.gyro)),
        vio_times=vio_times, lidar_times=lidar_times,
        sweeps=jax.tree_util.tree_map(np.asarray, sweeps),
        vio=(np.asarray(vio_pose), np.asarray(odo.cov), np.asarray(odo.cov)),
        pose0=np.asarray(traj.pose_fn(t0)), vel0=np.asarray(traj.vel_fn(t0)),
        guess_idx=(np.arange(len(lidar_times)) * 2 + 1).astype(np.int64))


def _jax_stages_2_to_4(cfg, d):
    """vil.py:139-186 with the VIO output given."""
    pose0 = jnp.asarray(d["pose0"])
    vio_pose, vio_cov, vio_twist = map(jnp.asarray, d["vio"])
    lidar_state = JLi.odometry.init(cfg.lidar, DT, pose0=pose0)
    vio_sel = vio_pose[jnp.asarray(d["guess_idx"])]
    prev = jnp.concatenate([pose0[None], vio_sel[:-1]], axis=0)
    guesses = jax.vmap(JL.pose_between)(prev, vio_sel)
    _, lidar_out = jax.jit(
        lambda st, sw, g: JLi.odometry.run(cfg.lidar, st, sw, g)
    )(lidar_state, d["sweeps"], guesses)
    gate_res = JDG.logdet_gate(lidar_out.hessian, cfg.gate,
                               n_corr=lidar_out.n_corr)
    lt = d["lidar_times"]
    dt_l = float(np.median(np.diff(lt)))
    lidar_cov = np.asarray(lidar_out.cov)
    tl = JFU.merge_timeline([
        (d["vio_times"], np.asarray(vio_pose), np.asarray(vio_cov),
         np.ones(len(d["vio_times"])), np.asarray(vio_twist)),
        (lt, np.asarray(lidar_out.pose), lidar_cov,
         np.asarray(gate_res.keep), lidar_cov / max(dt_l, 1e-3) ** 2),
    ])
    es0 = JFU.init(cfg.fusion, pose0, jnp.asarray(d["vel0"]),
                   jnp.zeros(6, DT), jnp.asarray(-1e-3, DT))
    imu_t, imu_a, imu_g = map(jnp.asarray, d["imu"])
    _, fused = jax.jit(lambda es, tl: JFU.run(
        cfg.fusion, es, tl, imu_t, imu_a, imu_g))(es0, tl)
    return lidar_out, gate_res, fused


def test_run_vil_matches_jax_stages():
    cfg = _config()
    d = _drive()
    lj, gj, fj = _jax_stages_2_to_4(cfg, d)

    c = convert.to_torch(cfg, "cpu")
    tt = lambda x: convert.to_torch(x, "cpu", torch.float64)
    pose0 = tt(d["pose0"])
    from vil_sensor_fusion_tpu_torch import fusion as TFU
    from vil_sensor_fusion_tpu_torch.frontends import lidar as TLi
    ls = TLi.odometry.init(c.lidar, torch.float64, pose0=pose0)
    es = TFU.init(c.fusion, pose0, tt(d["vel0"]),
                  torch.zeros(6, dtype=torch.float64),
                  torch.tensor(-1e-3, dtype=torch.float64))
    _, res = TVIL.run_vil(
        c, *tt(d["imu"]), d["vio_times"], TVIL.VioStream(*tt(d["vio"])),
        pose0, d["lidar_times"], convert.to_torch(d["sweeps"], "cpu"), ls,
        lidar_guess_from_vio_idx=d["guess_idx"], engine_state=es)

    np.testing.assert_allclose(res.lidar_out.pose.numpy(),
                               np.asarray(lj.pose), atol=1e-7)
    np.testing.assert_allclose(res.lidar_out.n_corr.numpy(),
                               np.asarray(lj.n_corr))
    np.testing.assert_array_equal(res.gate.keep.numpy(), np.asarray(gj.keep))
    assert res.gate.keep.numpy()[1:].sum() > 0   # the gate kept sweeps
    np.testing.assert_allclose(res.fused.poses.numpy(), np.asarray(fj.poses),
                               atol=1e-7)
    np.testing.assert_array_equal(res.fused.solved.numpy(),
                                  np.asarray(fj.solved))
    assert np.isfinite(res.fused.poses.numpy()).all()


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, in a fresh
    interpreter leaves ``jax`` out of ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vil_sensor_fusion_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__,"
        " P.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) > 25, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'vil_sensor_fusion_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

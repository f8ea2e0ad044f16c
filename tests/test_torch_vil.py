"""The port's ``run_vil`` against the JAX ``run_vil`` itself: VIO →
LiDAR odometry → log-det gate → fusion engine over a 0.5 s town drive with
synthetic feature tracks, on identical numpy inputs (the JAX scenario's
IMU stream, VIO frames and raycast sweeps), in float64.

Tolerances: f64 on both sides and the same algorithm. The VIO outputs
agree to round-off (1e-7; measured 2e-16), the gate decisions and the
solve flags exactly, the fused poses to 1e-7. The LiDAR stage given the
JAX run's own priors agrees to 1e-7 too (measured 6e-16). Inside
``run_vil`` its priors come from the port's VIO poses, 2e-16 away, and on
this drive that moves one line/plane correspondence of ~1400 across its
gate on sweep 2 (n_corr 1398 against 1397), which shifts that pose by
1.3e-6: the in-run LiDAR poses are held to 1e-5 and n_corr to ±2. Also
here: importing the whole port loads no JAX."""

import ast
import importlib
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
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends import vio as JV
from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JVM
from vil_sensor_fusion_tpu.fusion import vil as JVIL
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch import fusion as TFU
from vil_sensor_fusion_tpu_torch.frontends import lidar as TLi
from vil_sensor_fusion_tpu_torch.frontends import vio as TV
from vil_sensor_fusion_tpu_torch.fusion import vil as TVIL

DT = jnp.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    """The bench's operating point at narrow sizes: 12 landmark slots on a
    160×120 camera, maps 4096/8192, submaps 512/1024, smoother window 4."""
    cam = JV.camera.Camera(fx=107.0, fy=107.0, cx=80.0, cy=60.0,
                           width=160, height=120)
    vio = JV.VioConfig(num_landmarks=12, update_iters=2, cam=cam,
                       pose_ic=tuple(np.asarray(
                           JV.forward_camera_extrinsics(DT))))
    lidar = JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                          final_refresh=False, eig_sweeps=3),
        odom_icp=JLi.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                               fit_every=4, final_refresh=False,
                               eig_sweeps=3),
        corner_map=JVM.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=JVM.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024,
        two_stage=True, undistort=True, guess_is_delta=True)
    return JVIL.VilConfig(
        vio=vio, lidar=lidar,
        gate=JDG.GateConfig(4.0, -6.0, normalize_per_corr=True),
        fusion=JFU.FusionConfig(
            smoother=JG.SmootherConfig(window=4, between_slots=8,
                                       gn_iters=3),
            sensors=JVIL.VilConfig().fusion.sensors, max_imu_per_gap=32))


def _states(cfg, pose0, vel0, lib, dt):
    """(vio_state, lidar_state, engine_state) at the drive's start, made by
    ``lib`` (the JAX or the port's modules)."""
    V, Li, FU, z = lib
    return (V.init(cfg.vio, pose0, vel0, z(6)),
            Li.odometry.init(cfg.lidar, dt, pose0=pose0),
            FU.init(cfg.fusion, pose0, vel0, z(6), z(()) - 1e-3))


def test_run_vil_matches_jax():
    cfg = _config()
    sc = JSC.build("town", duration=0.5, vio_cfg=cfg.vio, dtype=DT)
    t0 = jnp.zeros((), DT)
    pose0, vel0 = sc.traj.pose_fn(t0), sc.traj.vel_fn(t0)
    vs, ls, es = _states(cfg, pose0, vel0,
                         (JV, JLi, JFU, lambda n: jnp.zeros(n, DT)), DT)
    _, rj = JVIL.run_vil(
        cfg, sc.imu_times, sc.imu_accel, sc.imu_gyro,
        sc.vio_times, sc.vio_frames, vs,
        sc.lidar_times, sc.sweeps, ls,
        lidar_guess_from_vio_idx=sc.lidar_guess_idx, engine_state=es)

    c = convert.to_torch(cfg, "cpu")
    tt = lambda x: convert.to_torch(x, "cpu", torch.float64)
    vs, ls, es = _states(
        c, tt(pose0), tt(vel0),
        (TV, TLi, TFU, lambda n: torch.zeros(n, dtype=torch.float64)),
        torch.float64)
    _, rt = TVIL.run_vil(
        c, tt(sc.imu_times), tt(sc.imu_accel), tt(sc.imu_gyro),
        sc.vio_times, tt(sc.vio_frames), vs,
        sc.lidar_times, tt(sc.sweeps), ls,
        lidar_guess_from_vio_idx=sc.lidar_guess_idx, engine_state=es)

    for f in ("pose", "vel", "cov", "twist_cov"):
        np.testing.assert_allclose(getattr(rt.vio_out, f).numpy(),
                                   np.asarray(getattr(rj.vio_out, f)),
                                   atol=1e-7)
    np.testing.assert_allclose(rt.lidar_out.pose.numpy(),
                               np.asarray(rj.lidar_out.pose), atol=1e-5)
    np.testing.assert_allclose(rt.lidar_out.n_corr.numpy(),
                               np.asarray(rj.lidar_out.n_corr), atol=2)
    # emit_dists is off: both sides return the zero-filled dists.
    assert rt.lidar_out.dists._fields == rj.lidar_out.dists._fields
    for a, b in zip(rt.lidar_out.dists, rj.lidar_out.dists):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The LiDAR stage from the JAX run's own priors (vil.py:139-154).
    vio_sel = rj.vio_out.pose[jnp.asarray(sc.lidar_guess_idx)]
    prev = jnp.concatenate([pose0[None], vio_sel[:-1]], axis=0)
    guesses = jax.vmap(JL.pose_between)(prev, vio_sel)
    _, lo = TLi.odometry.run(c.lidar, TLi.odometry.init(
        c.lidar, torch.float64, pose0=tt(pose0)), tt(sc.sweeps), tt(guesses))
    np.testing.assert_allclose(lo.pose.numpy(),
                               np.asarray(rj.lidar_out.pose), atol=1e-7)
    np.testing.assert_array_equal(lo.n_corr.numpy(),
                                  np.asarray(rj.lidar_out.n_corr))
    np.testing.assert_array_equal(rt.gate.keep.numpy(),
                                  np.asarray(rj.gate.keep))
    assert rt.gate.keep.numpy()[1:].sum() > 0   # the gate kept sweeps
    np.testing.assert_allclose(rt.fused.poses.numpy(),
                               np.asarray(rj.fused.poses), atol=1e-7)
    np.testing.assert_array_equal(rt.fused.solved.numpy(),
                                  np.asarray(rj.fused.solved))
    assert np.isfinite(rt.fused.poses.numpy()).all()
    vio_err = np.abs(rt.vio_out.pose.numpy()[:, 4:]
                     - sc.gt_vio_poses[:, 4:]).max()
    assert vio_err < 0.1


def test_photometric_vio_is_not_ported():
    """The photometric mode without its precomputed frame inputs raises
    the JAX ``run_vil``'s ValueError, with its message."""
    c = convert.to_torch(_config(), "cpu")
    c = c._replace(vio=c.vio._replace(use_photometric=True))
    with pytest.raises(ValueError) as want:
        JVIL.run_vil(c, *[None] * 9)
    with pytest.raises(ValueError) as got:
        TVIL.run_vil(c, *[None] * 9)
    assert str(got.value) == str(want.value)
    assert "requires photo_inputs" in str(got.value)


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
        "assert {'vil_sensor_fusion_tpu_torch.frontends.vio.photometric',"
        " 'vil_sensor_fusion_tpu_torch.graph.batch',"
        " 'vil_sensor_fusion_tpu_torch.soak',"
        " 'vil_sensor_fusion_tpu_torch.oracle_report',"
        " 'vil_sensor_fusion_tpu_torch.profile_stages',"
        " 'vil_sensor_fusion_tpu_torch.lidar_ablation',"
        " 'vil_sensor_fusion_tpu_torch.icp_scaling_curve',"
        " 'vil_sensor_fusion_tpu_torch.multihost_bench',"
        " 'vil_sensor_fusion_tpu_torch.window_sweep_quick'} <= set(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'vil_sensor_fusion_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_every_jax_module_has_a_port_counterpart():
    """The port mirrors the JAX package file for file: every ``*.py`` of
    ``vil_sensor_fusion_tpu/`` has a namesake in the port."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}
    jax_modules = modules("vil_sensor_fusion_tpu")
    assert len(jax_modules) > 40
    assert jax_modules - modules("vil_sensor_fusion_tpu_torch") == set()


def test_every_user_script_has_a_port_module():
    """Every user script of the JAX round (``scripts/*.py``) has a module
    of the same stem in the port, run as ``python -m
    vil_sensor_fusion_tpu_torch.<stem>``."""
    stems = {f[:-3] for f in os.listdir(os.path.join(REPO, "scripts"))
             if f.endswith(".py") and f != "__init__.py"}
    assert len(stems) == 7, stems
    port = os.path.join(REPO, "vil_sensor_fusion_tpu_torch")
    assert {s for s in stems
            if not os.path.isfile(os.path.join(port, s + ".py"))} == set()


def _public_names(path: str) -> set:
    """Public top-level names a module defines (functions, classes,
    assignments), and in a package's ``__init__.py`` also those it
    re-exports by import."""
    tree = ast.parse(open(path).read())
    init = os.path.basename(path) == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


# JAX public names whose port counterpart has another name (module of the
# JAX package → {name: the port's counterpart as "module:attribute"}).
_KNN = "vil_sensor_fusion_tpu_torch.ops.knn"
_PRECISION = "vil_sensor_fusion_tpu_torch._precision:require_full_f32"
RENAMED = {
    "ops/knn.py": {
        "knn_pallas": f"{_KNN}:knn_cuda",
        "knn_xla": f"{_KNN}:knn_torch",
        "knn_topk": f"{_KNN}:knn_torch",
        "knn_approx": f"{_KNN}:knn",          # the port's one exact k-NN
        "PALLAS_MAX_TARGETS": f"{_KNN}:_plan",
        "QUERY_BLOCK": f"{_KNN}:_plan",
        "TARGET_BLOCK": f"{_KNN}:_plan",
    },
    "ops/__init__.py": {
        "knn_pallas": "vil_sensor_fusion_tpu_torch.ops:knn_cuda",
        "knn_xla": "vil_sensor_fusion_tpu_torch.ops:knn_torch",
    },
    "_precision.py": {
        "ESTIMATION_PRECISION": _PRECISION,
        "estimation_precision": _PRECISION,
    },
    # Unused in the JAX package; the port's query tiling is the kernel's
    # plan.
    "frontends/lidar/icp.py": {"QUERY_CHUNK": f"{_KNN}:_plan"},
}


def _jax_module_files():
    root = os.path.join(REPO, "vil_sensor_fusion_tpu")
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".py"))


@pytest.mark.parametrize("rel", _jax_module_files())
def test_every_jax_public_name_has_a_port_counterpart(rel):
    """Every public top-level name of a JAX module has a namesake in the
    port's module, or a named counterpart in ``RENAMED`` that exists."""
    want = _public_names(os.path.join(REPO, "vil_sensor_fusion_tpu", rel))
    have = _public_names(os.path.join(REPO, "vil_sensor_fusion_tpu_torch",
                                      rel))
    renamed = RENAMED.get(rel, {})
    assert want - have - set(renamed) == set()
    assert set(renamed) <= want - have, "a renamed entry has a namesake"
    for target in renamed.values():
        mod, attr = target.split(":")
        assert hasattr(importlib.import_module(mod), attr), target

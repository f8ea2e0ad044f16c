"""The port's soak (``vil_sensor_fusion_tpu_torch/soak.py``) against the JAX
package, in float64 on the CPU.

``scripts/soak.py`` compiles its whole chunk as one program; on a CPU that
takes minutes per chunk, so the JAX side here is a rebuild of its chunk
handoff from the JAX package's public stage functions, in the order of its
``estimator_chunk`` (scripts/soak.py:184-235): ``track_frames(ts0=)``,
``vio.run``, ``pose_between`` priors from the carried ``vio_ref``,
``odometry.run``, ``logdet_gate``, the static-order ``Timeline`` and
``engine.run``, each stage jitted on its own. Two 0.5 s chunks (10 frames
and 5 sweeps each) at the soak's 160×120 rig with 8 landmarks, the state
carried; both sides take the same rendered inputs (the port renders them).
The JAX side runs in a child process while the port computes (the spawned
child imports this file).

The rig is the soak's, checked field for field against the JAX script's,
except the LiDAR maps, which are the narrow ones of
``test_torch_lidar.py::test_odometry_run_matches_jax`` (capacities 4,096 /
8,192, submaps 512 / 1,024): at the soak's full maps the JAX LiDAR stage
alone takes ~2 min per chunk on a CPU. The full-map soak runs end to end
in ``test_torch_soak_run.py``.

Tolerance: float64 on both sides with the same operations; every float
leaf of the carried states and every output is held to 1e-8 absolute plus
1e-9 relative (the EKF's landmark covariance starts at 1e4), masks and
integer leaves exactly; measured ~2e-15 on the poses."""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu import graph as JG
from vil_sensor_fusion_tpu import utils as JU
from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import synthetic as JSYN
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends import vio as JV
from vil_sensor_fusion_tpu.frontends.vio import frontend as JF
from vil_sensor_fusion_tpu.fusion import engine as JE
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch import soak as S
from vil_sensor_fusion_tpu_torch import utils as TU
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as TVM

CPU = torch.device("cpu")
DT = torch.float64
CAM = (160, 120)
LANDMARKS = 8
CHUNK = 0.5
N_CHUNKS = 2
ATOL, RTOL = 1e-8, 1e-9


def jax_rig(cam_w=800, cam_h=600, landmarks=24, dtype=jnp.float32,
            vio_use_odom_cov=False, vio_twist_cov=False, vio_cov=0.3,
            lidar_cov=0.05, gravity_update=True, zuv_update=True,
            lidar_anchor=False, anchor_scale=25.0, photometric=False):
    """(vio, frontend, lidar, gate, fusion) configs as scripts/soak.py:97-156
    builds them."""
    big_cam = cam_w >= 400
    cam = JV.camera.carla_camera(width=cam_w, height=cam_h) if big_cam else \
        JV.camera.Camera(fx=107.0 * cam_w / 160, fy=107.0 * cam_w / 160,
                         cx=cam_w / 2.0, cy=cam_h / 2.0,
                         width=cam_w, height=cam_h)
    pose_ic = JF.forward_camera_extrinsics(dtype)
    vio_cfg = JV.VioConfig(num_landmarks=landmarks, update_iters=2, cam=cam,
                           pose_ic=tuple(np.asarray(pose_ic)),
                           use_gravity_update=gravity_update,
                           use_zero_velocity_update=zuv_update,
                           use_photometric=photometric)
    fe_cfg = JF.FrontendConfig(
        cam=cam, n_candidates=64 if big_cam else 32,
        min_dist=24.0 if big_cam else 10.0, min_score=0.5)
    lidar_cfg = JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=6, degen_eigval=5.0, fit_every=2,
                          final_refresh=False, eig_sweeps=3),
        odom_icp=JLi.IcpConfig(iters=8, max_corr_dist=2.0, degen_eigval=5.0,
                               fit_every=2, final_refresh=False,
                               eig_sweeps=3),
        two_stage=True, undistort=True, guess_is_delta=True)
    gate_cfg = JDG.GateConfig(rot_threshold=4.0, trans_threshold=-6.0,
                              normalize_per_corr=True)
    sensors = (
        JFU.SensorSpec(name="vio", optimize_after_odom=True,
                       use_pose_covariance=vio_use_odom_cov,
                       use_odom_covariance=vio_twist_cov,
                       covariance_linear=vio_cov,
                       covariance_angular=vio_cov, max_time_skip=0.1),
        JFU.SensorSpec(name="lidar", optimize_after_odom=False,
                       use_odom_covariance=False, covariance_linear=lidar_cov,
                       covariance_angular=lidar_cov, max_time_skip=0.2,
                       absolute_anchor=lidar_anchor,
                       anchor_cov_scale=anchor_scale),
    )
    fusion_cfg = JFU.FusionConfig(
        smoother=JG.SmootherConfig(window=6, between_slots=12, gn_iters=4),
        sensors=sensors, max_imu_per_gap=32)
    return vio_cfg, fe_cfg, lidar_cfg, gate_cfg, fusion_cfg


def jax_trajectory(speed=4.0):
    """scripts/soak.py:87-95."""
    def pos_fn(t):
        return jnp.stack([speed * t, 2.0 * jnp.sin(0.25 * t),
                          1.5 + 0.0 * t])

    def rot_fn(t):
        yaw = jnp.arctan2(2.0 * 0.25 * jnp.cos(0.25 * t), speed)
        return JL.so3_exp(jnp.stack([0.0 * t, 0.0 * t, yaw]))

    return JSYN.trajectory(pos_fn, rot_fn)


SWITCHED = dict(vio_use_odom_cov=True, vio_twist_cov=True, vio_cov=0.2,
                lidar_cov=0.07, gravity_update=False, zuv_update=False,
                lidar_anchor=True, anchor_scale=30.0, photometric=True)


@pytest.mark.parametrize("rig", [
    pytest.param((800, 600, 24, {}), id="reference-rig"),
    pytest.param((160, 120, 16, SWITCHED), id="pinhole-switched"),
])
def test_soak_rig_matches_the_jax_script(rig):
    cam_w, cam_h, landmarks, kw = rig
    want = convert.to_torch(jax_rig(cam_w, cam_h, landmarks, **kw), "cpu")
    got = S.soak_rig(cam_w, cam_h, landmarks, **kw)
    assert tuple(got[:5]) == tuple(want)
    assert got.photometric == kw.get("photometric", False)


def test_chunk_indices_match_the_jax_script():
    """The static per-chunk structure of scripts/soak.py:158-175."""
    chunk, vio_hz, lidar_hz = 10.0, 20.0, 10.0
    Tv, Tl = int(chunk * vio_hz), int(chunk * lidar_hz)
    vio_rel = (np.arange(Tv) + 1.0) / vio_hz
    lidar_rel = (np.arange(Tl) + 1.0) / lidar_hz
    all_rel = np.concatenate([vio_rel, lidar_rel])
    order = np.argsort(all_rel, kind="stable")
    idx = S.chunk_indices(chunk, torch.float32, CPU)
    np.testing.assert_array_equal(idx.sw_idx.numpy(), np.clip(
        np.searchsorted(lidar_rel, vio_rel + 1e-9) - 1, 0, None))
    np.testing.assert_array_equal(idx.guess_idx.numpy(), np.clip(
        np.searchsorted(vio_rel, lidar_rel + 1e-9) - 1, 0, None))
    np.testing.assert_array_equal(idx.order.numpy(), order)
    np.testing.assert_array_equal(idx.src.numpy(), np.concatenate(
        [np.zeros(Tv, np.int32), np.ones(Tl, np.int32)])[order])
    assert idx.src.dtype == torch.int32
    np.testing.assert_array_equal(
        idx.rel_sorted.numpy(),
        np.asarray(jnp.asarray(all_rel[order], jnp.float32)))
    np.testing.assert_array_equal(idx.rel_sorted_np, all_rel[order])


def _narrow(lidar):
    return lidar._replace(
        corner_map=lidar.corner_map._replace(capacity=4096),
        surf_map=lidar.surf_map._replace(capacity=8192),
        submap_corners=512, submap_surfs=1024)


def _jax_fresh_state(cfgs, traj):
    """scripts/soak.py:240-260 in float64."""
    vio_cfg, fe_cfg, lidar_cfg, _, fusion_cfg = cfgs
    t0j = jnp.zeros((), jnp.float64)
    pose0, vel0 = traj.pose_fn(t0j), traj.vel_fn(t0j)
    return dict(
        tracker=JF.init_tracker(fe_cfg, vio_cfg.num_landmarks, jnp.float64),
        vio=JV.init(vio_cfg, pose0, vel0, jnp.zeros(6, jnp.float64)),
        lidar=JLi.odometry.init(lidar_cfg, jnp.float64, pose0=pose0),
        engine=JFU.init(fusion_cfg, pose0, vel0, jnp.zeros(6, jnp.float64),
                        t0j - 1e-3),
        vio_ref=pose0)


def _jax_stages(cfgs):
    vio_cfg, fe_cfg, lidar_cfg, _, fusion_cfg = cfgs
    return dict(
        track=jax.jit(lambda ts, py, cu, cs, cd, prj, iw: JF.track_frames(
            fe_cfg, py, cu, cs, cd, prj, iw, vio_cfg.num_landmarks,
            ts0=ts)),
        vio=jax.jit(lambda s, f: JV.run(vio_cfg, s, f)),
        lidar=jax.jit(lambda s, sw, g: JLi.odometry.run(lidar_cfg, s, sw, g)),
        engine=jax.jit(lambda e, tl, t, a, g: JE.run(fusion_cfg, e, tl, t, a,
                                                     g)))


def _jax_chunk(cfgs, stages, idx, state, py, cu, cs, cd, prj, imu_w, sweeps,
               t_off, imu_t, imu_a, imu_g):
    """scripts/soak.py's estimator_chunk, stage by stage."""
    gate_cfg, dtype = cfgs[3], jnp.float64
    guess_idx, order = jnp.asarray(idx["guess_idx"]), jnp.asarray(idx["order"])
    frames, ts1 = stages["track"](state["tracker"], py, cu, cs, cd, prj,
                                  imu_w)
    vs1, vio_out = stages["vio"](state["vio"], frames)
    vio_sel = vio_out.pose[guess_idx]
    prev_sel = jnp.concatenate([state["vio_ref"][None], vio_sel[:-1]], axis=0)
    guesses = jax.vmap(JL.pose_between)(prev_sel, vio_sel)
    ls1, lidar_out = stages["lidar"](state["lidar"], sweeps, guesses)
    gres = JDG.logdet_gate(lidar_out.hessian, gate_cfg,
                           n_corr=lidar_out.n_corr)
    Tv, E_ = vio_out.pose.shape[0], order.shape[0]
    lidar_twist = lidar_out.cov / jnp.asarray((1.0 / 10.0) ** 2, dtype)
    tl = JE.Timeline(
        times=(t_off + jnp.asarray(idx["rel_sorted"])).astype(dtype),
        source=jnp.asarray(idx["src"]),
        odo_pose=jnp.concatenate([vio_out.pose, lidar_out.pose])[order],
        odo_cov=jnp.concatenate([vio_out.cov, lidar_out.cov])[order],
        keep=jnp.concatenate([jnp.ones((Tv,), dtype), gres.keep])[order],
        valid=jnp.ones((E_,), dtype),
        odo_twist_cov=jnp.concatenate([vio_out.twist_cov,
                                       lidar_twist])[order])
    es1, fused = stages["engine"](state["engine"], tl, imu_t, imu_a, imu_g)
    new_state = dict(tracker=ts1, vio=vs1, lidar=ls1, engine=es1,
                     vio_ref=vio_sel[-1])
    return new_state, (vio_out, lidar_out, gres, fused)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(tree))


def _jax_cfgs():
    cfgs = jax_rig(*CAM, LANDMARKS, jnp.float64)
    return cfgs[:2] + (_narrow(cfgs[2]),) + cfgs[3:]


def _jax_side(idx, inputs, ckpt):
    """The JAX rebuild over the chunks' inputs (numpy trees), from its
    fresh state; the state after the first chunk saved to ``ckpt`` with
    JAX's ``utils.save``. Returns the fresh state and per chunk (state,
    outputs), as numpy trees."""
    jax.config.update("jax_enable_x64", True)
    cfgs = _jax_cfgs()
    st = _jax_fresh_state(cfgs, jax_trajectory())
    stages = _jax_stages(cfgs)
    fresh, out = jax.tree_util.tree_map(np.asarray, st), []
    for k, (tc0, x) in enumerate(inputs):
        st, o = _jax_chunk(cfgs, stages, idx, st, *_jnp(x[:-1]),
                           jnp.asarray(tc0, jnp.float64), *_jnp(x[-1]))
        if k == 0:
            JU.save(ckpt, st)
        out.append(jax.tree_util.tree_map(np.asarray, (st, o)))
    return fresh, out


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """Both sides over N_CHUNKS chunks from their fresh states; per chunk
    the port's and the JAX rebuild's (state, outputs) as numpy trees, and
    the JAX state after the first chunk saved with JAX's ``utils.save``."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rig = S.soak_rig(*CAM, LANDMARKS, dtype=DT)
        rig = rig._replace(lidar=_narrow(rig.lidar))
        assert tuple(rig[:5]) == tuple(convert.to_torch(_jax_cfgs(), "cpu"))
        traj = S.soak_trajectory()
        idx = S.chunk_indices(CHUNK, DT, CPU)
        world = S.rc.road_world(length=4.0 * N_CHUNKS * CHUNK, seed=0,
                                dtype=DT, device=CPU)
        inputs = []
        for k in range(N_CHUNKS):
            tc0 = k * CHUNK
            x = S.render_chunk(world, traj, rig, idx, tc0, CHUNK, DT, CPU)
            py = S.F.pyramids_batch(rig.frontend, x.images)
            cand = S.F.candidates_batch(rig.frontend, x.images, x.pts_cam,
                                        x.sw_msk)
            inputs.append((tc0, (py, *cand, x.imu_w, x.sweeps, x.imu)))
        ckpt = str(tmp_path_factory.mktemp("soak") / "jax_state.npz")
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(1, mp_context=ctx) as pool:
            jax_run = pool.submit(
                _jax_side, {f: getattr(idx, f).numpy() for f in (
                    "guess_idx", "order", "src", "rel_sorted")},
                [(tc0, convert.to_numpy(x)) for tc0, x in inputs], ckpt)
            st = S.fresh_state(rig, traj, DT, CPU)
            fresh_t, out_t = convert.to_numpy(st), []
            for tc0, x in inputs:
                st, o = S.estimator_chunk(
                    rig, idx, st, *x[:-1], torch.as_tensor(tc0, dtype=DT),
                    *x[-1])
                out_t.append((convert.to_numpy(st), convert.to_numpy(o)))
            fresh_j, out_j = jax_run.result()
        return dict(rig=rig, traj=traj, fresh=(fresh_t, fresh_j),
                    chunks=list(zip(out_t, out_j)), ckpt=ckpt)
    finally:
        torch.set_num_threads(n_threads)


def _assert_trees_close(a, b, what):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert len(la) == len(lb), what
    for n, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, (what, n, x.shape, y.shape)
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what} leaf {n}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {n}")


def test_fresh_state_matches_the_jax_script(chunks):
    """``fresh_state`` as scripts/soak.py:244-260 (the trajectory's start
    pose and velocity included)."""
    st_t, st_j = chunks["fresh"]
    assert sorted(st_t) == sorted(st_j)
    for key in st_t:
        _assert_trees_close(st_t[key], st_j[key], f"fresh {key}")


@pytest.mark.parametrize("k", range(N_CHUNKS))
@pytest.mark.parametrize("key", ["tracker", "vio", "lidar", "engine",
                                 "vio_ref"])
def test_carried_state_matches_jax(chunks, k, key):
    """Every stage's state after chunk ``k``, carried from chunk to chunk."""
    (st_t, _), (st_j, _) = chunks["chunks"][k]
    _assert_trees_close(st_t[key], st_j[key], f"chunk {k} {key}")


@pytest.mark.parametrize("k", range(N_CHUNKS))
def test_chunk_outputs_match_jax(chunks, k):
    """VIO and LiDAR poses, the gate's keep, the fused poses and health,
    and the maps' masks, chunk by chunk."""
    (st_t, o_t), (st_j, (vio_j, lidar_j, gate_j, fused_j)) = (
        chunks["chunks"][k])
    for name, a, b in (("vio", o_t.vio, vio_j), ("lidar", o_t.lidar, lidar_j),
                       ("fused", o_t.fused, fused_j)):
        _assert_trees_close(a, b, f"chunk {k} {name}")
    np.testing.assert_array_equal(o_t.gate.keep, gate_j.keep)
    for m in ("corner_map", "surf_map"):
        np.testing.assert_array_equal(getattr(st_t["lidar"], m).mask,
                                      getattr(st_j["lidar"], m).mask)
    assert st_t["lidar"].surf_map.mask.sum() > 1000
    assert np.isfinite(o_t.fused.poses).all()
    assert o_t.fused.healthy.min() == 1.0
    # The chunk's events are stamped from its start: t_off + rel in f64.
    np.testing.assert_array_equal(
        o_t.fused.times, np.asarray(fused_j.times))
    assert o_t.fused.times[0] == pytest.approx(k * CHUNK + 0.05)


def test_jax_checkpoint_restores_into_the_ports_fresh_state(chunks):
    """The JAX state after the first chunk, written by JAX's
    ``utils.save``, restored into the port's ``fresh_state()`` template by
    the port's ``utils.restore``: every leaf comes back under the same key
    path, bit for bit, on the template's device and dtype."""
    fresh = S.fresh_state(chunks["rig"], chunks["traj"], DT, CPU)
    restored = TU.restore(chunks["ckpt"], fresh)
    (_, _), (st_j, _) = chunks["chunks"][0]
    assert sorted(restored) == sorted(st_j)
    for key in restored:
        la = jax.tree_util.tree_leaves(convert.to_numpy(restored[key]))
        lb = jax.tree_util.tree_leaves(st_j[key])
        assert len(la) == len(lb) > 0, key
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y, err_msg=key)
    leaves = jax.tree_util.tree_leaves(
        restored, is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert all(v.device == CPU and (v.dtype == DT or not v.is_floating_point())
               for v in leaves)
    assert os.path.getsize(chunks["ckpt"]) > 0

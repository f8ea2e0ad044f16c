"""The degeneracy-experiment slice of the port against the JAX package:
scenario → ``run_vil`` with ``emit_dists`` → metric scores, gate log-dets
and dist slopes per sweep, on a 0.5 s motion-distorted corridor drive built
by JAX and handed over, in float64, with the narrow configuration of
``test_torch_vil.py`` and ``emit_dists``.

The JAX side is the composition the JAX ``experiments._run`` makes of
public functions (``run_vil``, ``score_series``, ``dist_slopes_6dof``, the
raw ``logdet_gate``); the port's side is its ``experiments.run_scenario``.
Tolerances: the port's scoring of the JAX run's own Hessians and dists
agrees to 1e-9 with identical NaN / ±inf masks. The in-run values are held
as in ``test_run_vil_matches_jax`` (LiDAR poses 1e-5, n_corr ±2: the
port's VIO poses are round-off away from JAX's and can move one
correspondence across its gate), and every score series has JAX's NaN and
±inf mask."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.degeneracy import metrics as JM
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends import vio as JV
from vil_sensor_fusion_tpu.fusion import vil as JVIL
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC
from vil_sensor_fusion_tpu_torch.degeneracy import gate as TDG
from vil_sensor_fusion_tpu_torch.degeneracy import metrics as TM
from vil_sensor_fusion_tpu_torch.eval import experiments as TEX

from test_torch_eval import assert_close
from test_torch_vil import _config

DT = jnp.float64
AXES = ("tx", "ty", "tz", "rx", "ry", "rz")


def _jax_scores(hessian, gate, dists):
    """The JAX ``_run``'s score dict from a run's Hessians, gate and
    dists."""
    series = JDG.score_series(TEX.METRIC_NAMES, hessian)
    out = {n: s.score_trans for n, s in series.items()}
    out.update({f"{n}_rot": s.score_rot for n, s in series.items()})
    out["gate_trans_logdet"] = gate.trans_d_opt
    out["gate_rot_logdet"] = gate.rot_d_opt
    raw = JDG.logdet_gate(hessian, JDG.GateConfig(normalize_per_corr=False))
    out["gate_trans_logdet_raw"] = raw.trans_d_opt
    out["gate_rot_logdet_raw"] = raw.rot_d_opt
    slopes = JM.dist_slopes_6dof(dists.dists, dists.shift_trans[0],
                                 dists.shift_rot[0])
    out.update({f"dist_slope_{a}": slopes[:, i] for i, a in enumerate(AXES)})
    return {k: np.asarray(v) for k, v in out.items()}


def test_experiment_slice_matches_jax():
    cfg = _config()
    cfg = cfg._replace(lidar=cfg.lidar._replace(emit_dists=True))
    spec = TEX.ExperimentSpec(kind="corridor", duration=0.5)
    sc = JSC.build("corridor", duration=0.5, vio_cfg=cfg.vio, dtype=DT,
                   distort_sweeps=True)
    t0 = jnp.zeros((), DT)
    pose0, vel0 = sc.traj.pose_fn(t0), sc.traj.vel_fn(t0)
    _, rj = JVIL.run_vil(
        cfg, sc.imu_times, sc.imu_accel, sc.imu_gyro,
        sc.vio_times, sc.vio_frames,
        JV.init(cfg.vio, pose0, vel0, jnp.zeros(6, DT)),
        sc.lidar_times, sc.sweeps,
        JLi.odometry.init(cfg.lidar, DT, pose0=pose0),
        lidar_guess_from_vio_idx=sc.lidar_guess_idx,
        engine_state=JFU.init(cfg.fusion, pose0, vel0, jnp.zeros(6, DT), t0))
    sj = _jax_scores(rj.lidar_out.hessian, rj.gate, rj.lidar_out.dists)

    # The port scores the JAX run's own Hessians, gate and dists: 1e-9.
    tt = lambda x: convert.to_torch(x, "cpu", torch.float64)
    H = tt(rj.lidar_out.hessian)
    series = TDG.score_series(TEX.METRIC_NAMES, H)
    d = tt(rj.lidar_out.dists)
    slopes = TM.dist_slopes_6dof(d.dists, d.shift_trans[0], d.shift_rot[0])
    for n, s in series.items():
        assert_close(s.score_trans, sj[n], rtol=1e-9, atol=1e-9)
        assert_close(s.score_rot, sj[f"{n}_rot"], rtol=1e-9, atol=1e-9)
    raw = TDG.logdet_gate(H, TDG.GateConfig(normalize_per_corr=False))
    assert_close(raw.trans_d_opt, sj["gate_trans_logdet_raw"], rtol=1e-9,
                 atol=1e-9)
    for i, a in enumerate(AXES):
        assert_close(slopes[:, i], sj[f"dist_slope_{a}"], rtol=1e-9,
                     atol=1e-9)

    # The port's own run through experiments.run_scenario.
    tsc = tt(sc)._replace(traj=TSC._corridor_traj())
    out = TEX.run_scenario(spec, convert.to_torch(cfg, "cpu"), tsc)
    assert out["spec"] == dataclasses.asdict(spec)
    assert out["events"] == 15
    assert set(out["scores"]) == set(sj)
    for name, s in sj.items():
        for mask in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(mask(out["scores"][name]), mask(s),
                                          err_msg=name)
    np.testing.assert_allclose(out["lidar_poses"],
                               np.asarray(rj.lidar_out.pose), atol=1e-5)
    np.testing.assert_allclose(out["n_corr"], np.asarray(rj.lidar_out.n_corr),
                               atol=2)
    np.testing.assert_array_equal(out["gate_keep"], np.asarray(rj.gate.keep))
    np.testing.assert_allclose(out["fused_poses"], np.asarray(rj.fused.poses),
                               atol=1e-5)
    assert out["degen_windows"] == [list(w) for w in sc.degen_windows]
    gt_fused = np.asarray(jax.vmap(sc.traj.pose_fn)(rj.timeline.times))
    np.testing.assert_allclose(out["gt_fused_poses"], gt_fused, atol=1e-12)
    err = np.asarray(rj.lidar_out.pose)[:, 4:] - sc.gt_lidar_poses[:, 4:]
    np.testing.assert_allclose(out["ate_lidar"],
                               np.sqrt(np.mean(np.sum(err ** 2, -1))),
                               atol=1e-5)
    # The corridor starves x: the along-axis slope stays below the
    # cross-axis ones after the first sweep.
    st = np.stack([out["scores"][f"dist_slope_{a}"] for a in AXES[:3]], 1)
    assert (st[1:, 0] < 0.5 * np.maximum(st[1:, 1], st[1:, 2])).all(), st

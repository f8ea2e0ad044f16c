"""The degeneracy-experiment slice of the port against the JAX package:
scenario → ``run_vil`` with ``emit_dists`` → metric scores, gate log-dets
and dist slopes per sweep, on a 0.5 s motion-distorted drive of each
degenerate kind (the corridor, and ``default_grid``'s tunnel and field)
built by JAX and handed over with the port's trajectory of that kind, in
float64, with the narrow configuration of ``test_torch_vil.py`` and
``emit_dists``.

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
import pytest
import jax
import jax.numpy as jnp
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.degeneracy import metrics as JM
from vil_sensor_fusion_tpu.eval import experiments as JEX
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files side by side, one
    worker each, and these tests run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["corridor", "tunnel", "field"])
def test_experiment_slice_matches_jax(kind):
    cfg = _config()
    cfg = cfg._replace(lidar=cfg.lidar._replace(emit_dists=True))
    spec = TEX.ExperimentSpec(kind=kind, duration=0.5)
    sc = JSC.build(kind, duration=0.5, vio_cfg=cfg.vio, dtype=DT,
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

    # The port's own run through experiments.run_scenario, on the JAX
    # scenario with the port's trajectory of the kind.
    traj = TSC._kind(kind, 0.5, 0, torch.float64, "cpu")[1]
    tsc = tt(sc)._replace(traj=traj)
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
    if kind == "corridor":
        # The corridor starves x: the along-axis slope stays below the
        # cross-axis ones after the first sweep.
        st = np.stack([out["scores"][f"dist_slope_{a}"] for a in AXES[:3]],
                      1)
        assert (st[1:, 0] < 0.5 * np.maximum(st[1:, 1], st[1:, 2])).all(), st


def test_saved_result_is_loaded_not_run(tmp_path, monkeypatch):
    """A result written by ``save_result`` at ``cache_path`` is what
    ``run_experiment`` returns, in the port and in JAX (the same spec key
    and file format), and neither runs the cell again."""
    spec = TEX.ExperimentSpec(kind="tunnel", duration=0.8)
    rng = np.random.default_rng(3)
    out = {"spec": dataclasses.asdict(spec), "events": 24,
           "ate_fused": 0.25, "degen_windows": [[0.4, 0.4, "trans"]],
           "lidar_times": np.arange(8) / 10.0,
           "n_corr": rng.integers(100, 200, 8).astype(np.float32),
           "scores": {"e_opt": rng.standard_normal(8),
                      "dist_slope_tx": np.array([np.nan, 1, 2, 3, 4, 5, 6,
                                                 np.inf])}}
    TEX.save_result(out, TEX.cache_path(spec, str(tmp_path)))
    assert spec.key() == JEX.ExperimentSpec(**out["spec"]).key()

    def refuse(*a, **k):
        raise AssertionError("a cached cell ran again")
    monkeypatch.setattr(TEX, "_run", refuse)
    monkeypatch.setattr(JEX, "_run", refuse)
    for back in (TEX.run_experiment(spec, str(tmp_path), device="cpu"),
                 JEX.run_experiment(JEX.ExperimentSpec(**out["spec"]),
                                    str(tmp_path))):
        assert set(back) == set(out)
        assert back["spec"] == out["spec"] and int(back["events"]) == 24
        assert back["degen_windows"] == out["degen_windows"]
        for k in ("lidar_times", "n_corr"):
            np.testing.assert_array_equal(back[k], out[k])
        for k, v in out["scores"].items():
            np.testing.assert_array_equal(back["scores"][k], v)

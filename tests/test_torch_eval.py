"""Parity of the port's ``eval/`` package with the JAX package, in float64
on identical numpy inputs: ``roc`` (score quantiles, NaN and -inf series,
both polarities), ``label_windows``, ``auc_table``, the ``diagnostics``
functions and ``correlations.search`` / ``search_sources`` to 1e-10; the
experiment harness's polarity and note tables, ``ExperimentSpec.key`` and
both grids equal; and ``report``, ``aggregate_report``,
``calibrate_thresholds`` and ``raw_threshold_parity`` on the same synthetic
result dicts (NaN series included) give JSON summaries within 1e-12."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import eval as JE
from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.eval import correlations as JC
from vil_sensor_fusion_tpu.eval import diagnostics as JDI
from vil_sensor_fusion_tpu.eval import experiments as JEX
from vil_sensor_fusion_tpu.eval import roc as JR
from vil_sensor_fusion_tpu.eval import trajectory_view as JTV
from vil_sensor_fusion_tpu_torch import eval as TE
from vil_sensor_fusion_tpu_torch.eval import correlations as TC
from vil_sensor_fusion_tpu_torch.eval import diagnostics as TDI
from vil_sensor_fusion_tpu_torch.eval import experiments as TEX
from vil_sensor_fusion_tpu_torch.eval import roc as TR
from vil_sensor_fusion_tpu_torch.eval import trajectory_view as TTV

TOL = dict(rtol=1e-10, atol=1e-10)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(t, j, **kw):
    t, j = _np(t), _np(j)
    for mask in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(mask(t), mask(j))
    f = np.isfinite(j)
    np.testing.assert_allclose(t[f], j[f], **(kw or TOL))


def _scores(rng, n=80):
    """Score series as runs make them: ties, a -inf first sweep, a NaN."""
    base = np.round(rng.normal(0.0, 1.0, n), 1)
    lab = (base + rng.normal(0.0, 0.8, n)) < 0.0
    with_inf = base.copy()
    with_inf[0] = -np.inf
    with_nan = base.copy()
    with_nan[1] = np.nan
    return lab, {"plain": base, "ties": np.round(base), "neg_inf": with_inf,
                 "nan": with_nan, "f32": base.astype(np.float32)}


@pytest.mark.parametrize("low", [True, False])
def test_roc_matches_jax(low):
    lab, scores = _scores(np.random.default_rng(0))
    for name, s in scores.items():
        for K in (100, 7):
            cj = JR.roc(jnp.asarray(lab), jnp.asarray(s), K,
                        low_is_degenerate=low)
            ct = TR.roc(torch.from_numpy(lab), torch.from_numpy(s), K,
                        low_is_degenerate=low)
            for f in cj._fields:
                assert_close(getattr(ct, f), getattr(cj, f))
            assert ct.thresholds.dtype == torch.from_numpy(s).dtype, name
    # A series with a NaN scores AUC 0 (every comparison false), as in JAX.
    assert float(TR.roc(torch.from_numpy(lab),
                        torch.from_numpy(scores["nan"])).auc) == 0.0


def test_label_windows_and_auc_table_match_jax():
    t = np.arange(0.1, 6.0, 0.1)
    windows = [(0.5, 1.5), (2.0, 3.0, "rot"), (3.5, 4.0, "both"),
               (4.5, 5.2, "trans")]
    for kind in (None, "trans", "rot"):
        np.testing.assert_array_equal(
            TR.label_windows(torch.from_numpy(t), windows, kind).numpy(),
            np.asarray(JR.label_windows(jnp.asarray(t), windows, kind)))
    lab = JR.label_windows(jnp.asarray(t), windows, "trans")
    rng = np.random.default_rng(1)
    s = {f"m{i}": rng.normal(size=t.shape) + i * np.asarray(lab)
         for i in range(3)}
    tj = JR.auc_table({k: jnp.asarray(v) for k, v in s.items()}, lab)
    tt = TR.auc_table({k: torch.from_numpy(v) for k, v in s.items()},
                      torch.from_numpy(np.asarray(lab)))
    assert tt.keys() == tj.keys()
    np.testing.assert_allclose(list(tt.values()), list(tj.values()), **TOL)


def _trajectories(T=40):
    """A GT drive and an estimate with drift, noise and a gauge offset."""
    rng = np.random.default_rng(2)
    t = np.arange(T) * 0.1
    xyz = np.stack([4.0 * t, 2.0 * np.sin(0.25 * t), 1.5 + 0 * t], -1)
    yaw = 0.1 * np.sin(0.3 * t)
    q = np.stack([np.cos(yaw / 2), 0 * t, 0 * t, np.sin(yaw / 2)], -1)
    gt = np.concatenate([q, xyz], -1)
    gt[3] = gt[2]                                  # a zero step
    xi = np.concatenate([0.02 * rng.normal(size=(T, 3)) + 0.01 * t[:, None],
                         0.01 * rng.normal(size=(T, 3))], -1)
    est = np.asarray(jax.vmap(JL.pose_retract)(jnp.asarray(gt),
                                               jnp.asarray(xi)))
    g = np.asarray(JL.pose_make(JL.so3_exp_quat(jnp.array([0.0, 0.0, 0.3])),
                                jnp.array([5.0, -2.0, 0.5])))
    est = np.asarray(jax.vmap(lambda p: JL.pose_compose(jnp.asarray(g), p))(
        jnp.asarray(est)))
    return t, est, gt


def test_diagnostics_match_jax():
    t, est, gt = _trajectories()
    dj = JDI.diagnostics(jnp.asarray(t), jnp.asarray(est), jnp.asarray(gt))
    dt = TDI.diagnostics(*(torch.from_numpy(x) for x in (t, est, gt)))
    for f in dj._fields:
        assert_close(getattr(dt, f), getattr(dj, f))
    assert np.isinf(_np(dt.rel_linear_vel_err)).any()   # the zero step
    aj = JDI.anchor_first_pose(jnp.asarray(est), jnp.asarray(gt))
    at = TDI.anchor_first_pose(torch.from_numpy(est), torch.from_numpy(gt))
    assert_close(at, aj)
    for scale in (False, True):
        rj = JDI.umeyama_alignment(jnp.asarray(est[:, 4:]),
                                   jnp.asarray(gt[:, 4:]), with_scale=scale)
        rt = TDI.umeyama_alignment(torch.from_numpy(est[:, 4:]),
                                   torch.from_numpy(gt[:, 4:]),
                                   with_scale=scale)
        for a, b in zip(rt, rj):
            assert_close(a, b)
    for align in (False, True):
        assert_close(TDI.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt),
                                  align=align),
                     JDI.ate_rmse(jnp.asarray(est), jnp.asarray(gt),
                                  align=align))
    for stride in (1, 5):
        for a, b in zip(TDI.rpe(torch.from_numpy(est), torch.from_numpy(gt),
                                stride),
                        JDI.rpe(jnp.asarray(est), jnp.asarray(gt), stride)):
            assert_close(a, b)


def _hessians(rng, T=30):
    A = rng.standard_normal((T, 6, 6))
    H = A @ np.swapaxes(A, -1, -2) + np.eye(6)
    H[0] = 0.0                                     # map-seeding first sweep
    return H


def test_correlation_search_matches_jax():
    rng = np.random.default_rng(3)
    H = _hessians(rng)
    H[10:20, 0, 0] *= 30.0
    err = {"planted": np.log(H[:, 0, 0] + 1.0) + 0.1 * rng.normal(size=30),
           "noise": rng.normal(size=30),
           "with_nan": np.where(np.arange(30) == 4, np.nan,
                                rng.normal(size=30))}
    names = ["d_opt", "a_opt", "e_opt_ratio", "kullback_leibler"]
    poses = rng.normal(size=(30, 6))
    for p in (None, poses):
        rj = JC.search(names, jnp.asarray(H), err,
                       None if p is None else jnp.asarray(p), top_k=40)
        rt = TC.search(names, torch.from_numpy(H), err,
                       None if p is None else torch.from_numpy(p), top_k=40)
        assert [r[:4] + r[5:] for r in rt] == [r[:4] + r[5:] for r in rj]
        np.testing.assert_allclose([r.pearson_r for r in rt],
                                   [r.pearson_r for r in rj], **TOL)
    src = {"hessian": H, "scaled": 2.0 * H + np.eye(6)}
    rj = JC.search_sources(names, {k: jnp.asarray(v) for k, v in src.items()},
                           err, top_k=25)
    rt = TC.search_sources(names, {k: torch.from_numpy(v)
                                   for k, v in src.items()}, err, top_k=25)
    assert [r.source for r in rt] == [r.source for r in rj]
    np.testing.assert_allclose([r.pearson_r for r in rt],
                               [r.pearson_r for r in rj], **TOL)


METRIC_KEYS = (
    [n for n in JEX.__dict__.get("_HIGH_IS_DEGENERATE_BASES", ())]
    + ["d_opt", "a_opt", "e_opt", "condition_number", "condition_cov",
       "differential_entropy", "norm_frobenius", "max_eigen", "d_opt_ratio",
       "e_opt_ratio", "gate_trans_logdet", "gate_rot_logdet",
       "gate_trans_logdet_raw", "gate_rot_logdet_raw", "something_else"]
    + [f"dist_slope_{a}" for a in ("tx", "ty", "tz", "rx", "ry", "rz")])


def test_polarity_note_tables_spec_keys_and_grids_match_jax():
    names = METRIC_KEYS + [n + "_rot" for n in METRIC_KEYS]
    for n in names:
        assert TEX._low_is_degenerate(n) == JEX._low_is_degenerate(n), n
        assert TEX._is_rot_metric(n) == JEX._is_rot_metric(n), n
        for auc in (0.0, 0.3, 0.49, 0.5, 0.9):
            assert TEX._auc_note(n, auc) == JEX._auc_note(n, auc), (n, auc)
    assert TEX._HIGH_IS_DEGENERATE_BASES == JEX._HIGH_IS_DEGENERATE_BASES
    assert TEX.REFERENCE_RAW_THRESHOLDS == JEX.REFERENCE_RAW_THRESHOLDS
    specs = [TEX.ExperimentSpec(), TEX.ExperimentSpec(kind="tunnel",
                                                      duration=60.0, seed=1),
             TEX.ExperimentSpec(kind="field", emit_dists=False,
                                icp_iters=8, trans_threshold=-5.5)]
    for s in specs:
        assert s.key() == JEX.ExperimentSpec(**vars(s)).key()
    for grid in ("default_grid", "smoke_grid"):
        for kw in ({}, {"seeds": (3,), "duration": 1.5}):
            assert ([vars(s) for s in getattr(TEX, grid)(**kw)]
                    == [vars(s) for s in getattr(JEX, grid)(**kw)])


def _result(kind, seed, rng, T=40, windows=()):
    """A synthetic result dict as ``_run`` returns one, with NaN and -inf
    series (a ratio metric, the first sweep's log-dets)."""
    lt = (np.arange(T) + 1.0) / 10.0
    vt = (np.arange(2 * T) + 1.0) / 20.0
    pose = np.zeros((T, 7))
    pose[:, 0] = 1.0
    pose[:, 4] = 4.0 * lt
    scores = {}
    for name in ("d_opt", "e_opt", "condition_number", "jensen_bregman",
                 "gate_trans_logdet", "gate_trans_logdet_raw",
                 "gate_rot_logdet", "gate_rot_logdet_raw", "d_opt_ratio",
                 "dist_slope_tx", "dist_slope_rz"):
        s = rng.normal(size=T) + 2.0
        if name.startswith("gate"):
            s[0] = -np.inf
        if name.endswith("_ratio"):
            s[1] = np.nan
        scores[name] = s
        scores[name + "_rot"] = rng.normal(size=T)
    for w in windows:
        inside = (lt >= w[0]) & (lt <= w[1])
        key = "gate_rot_logdet" if w[2] == "rot" else "gate_trans_logdet"
        scores[key][inside] -= 2.0
        scores[key + "_raw"][inside] -= 2.0
    return {
        "spec": {"kind": kind, "duration": T / 10.0, "seed": seed},
        "n_corr": rng.uniform(800, 1600, T),
        "ate_fused": 0.1 * seed + 0.05, "ate_vio": 0.2, "ate_lidar": 0.07,
        "gate_keep_fraction": 0.9,
        "degen_windows": [list(w) for w in windows],
        "lidar_times": lt, "vio_times": vt, "fused_times": np.sort(
            np.concatenate([lt, vt])),
        "err_fused": rng.uniform(0, 0.1, 3 * T),
        "err_vio": rng.uniform(0, 0.2, 2 * T),
        "err_lidar": rng.uniform(0, 0.1, T),
        "fused_poses": np.tile(pose[:1], (3 * T, 1)), "vio_poses":
        np.tile(pose[:1], (2 * T, 1)), "lidar_poses": pose,
        "gt_fused_poses": np.tile(pose[:1], (3 * T, 1)),
        "gate_keep": (rng.uniform(size=T) > 0.1).astype(float),
        "scores": scores,
    }


def _results():
    rng = np.random.default_rng(4)
    return [_result("town", 0, rng),
            _result("tunnel", 0, rng, windows=((1.0, 2.5, "trans"),)),
            _result("arena", 1, rng, windows=((0.0, 4.0, "rot"),)),
            _result("field", 0, rng, windows=((0.8, 3.0, "trans"),
                                              (1.5, 2.2, "rot")))]


def _assert_json_close(a, b, path=""):
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_json_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        if np.isnan(a):
            assert np.isnan(b), path
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                       err_msg=path)
    else:
        assert a == b, path


def test_reports_and_calibration_match_jax(tmp_path):
    results = _results()
    tj = JEX.calibrate_thresholds(results)
    tt = TEX.calibrate_thresholds(results)
    _assert_json_close(tt, tj)
    assert {"trans_threshold", "rot_threshold", "raw_trans_threshold",
            "raw_rot_threshold"} <= set(tt)
    _assert_json_close(TEX.raw_threshold_parity(results, tt),
                       JEX.raw_threshold_parity(results, tj))
    _assert_json_close(TEX.raw_threshold_parity([], {}),
                       JEX.raw_threshold_parity([], {}))
    for r in results:
        sj = JEX.report(r, str(tmp_path / "j" / r["spec"]["kind"]))
        st = TEX.report(r, str(tmp_path / "t" / r["spec"]["kind"]))
        _assert_json_close(st, sj)
    aj = JEX.aggregate_report(results, str(tmp_path / "j" / "agg"))
    at = TEX.aggregate_report(results, str(tmp_path / "t" / "agg"))
    _assert_json_close(at, aj)
    assert at["auc"]["d_opt_ratio"] == 0.0           # the NaN series
    for f in ("roc_all.png", "ate_table.png", "summary.json"):
        assert os.path.exists(tmp_path / "t" / "agg" / f)
    with open(tmp_path / "t" / "agg" / "summary.json") as f:
        _assert_json_close(json.load(f), json.loads(json.dumps(at)))
    for f in ("error_over_time.png", "metrics_over_time.png", "roc.png",
              "trajectory.html", "report.json"):
        assert os.path.exists(tmp_path / "t" / "tunnel" / f), f


def test_trajectory_view_matches_jax(tmp_path):
    t, est, gt = _trajectories(12)
    tracks = {"gt": (t, gt), "fused": (t, est), "lidar": (t[::2], est[::2])}
    keep = np.array([1, 0, 1, 1, 0, 1], float)
    pj = JTV.write_view(str(tmp_path / "j.html"), tracks, keep, title="x")
    pt = TTV.write_view(str(tmp_path / "t.html"), tracks, keep, title="x")
    assert open(pt).read() == open(pj).read()


def test_eval_exports_match_jax():
    assert set(TE.__all__) == set(JE.__all__)
    for name in JE.__all__:
        assert hasattr(TE, name), name

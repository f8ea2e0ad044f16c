"""Batch experiment harness — the reference's experiment pipeline
(carla_tools/scripts/auto_experiments.py:52-99 records bags,
vil_fusion/python/quick_autoexperiments.py:37-73 replays them,
make_prettier_graphs.py caches numpified results and draws the per-bag
report figures).

Port of ``vil_sensor_fusion_tpu/eval/experiments.py``. One call runs a
{scenario × seed} grid through the full VIL system on the card, caches each
run's result arrays on disk keyed by the experiment spec, and emits per-run
reports (error over time, degeneracy-metric series over the labeled
windows, ROC curves and the AUC table, the dist_slope metrics when the
pipeline emits dists), then a pooled report with calibrated gate
thresholds.

``_run`` is split in three here: :func:`experiment_config` (the
spec's ``VilConfig``), :func:`experiment_scenario` (its drive, built on a
given device) and :func:`run_scenario` (a config over a scenario, through
``run_vil``, to the numpy result dict). Scores are computed on the device
that holds the Hessians; results become numpy only at the end. The report
functions work on those numpy dicts; ``report`` and ``aggregate_report``
draw with matplotlib, imported lazily (``plots._plt``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping, Sequence

import numpy as np
import torch
from torch.func import vmap

from .. import DEFAULT_DEVICE
from .. import graph as G
from ..data import scenarios
from ..degeneracy import gate as DG
from ..degeneracy import metrics as M
from ..frontends import lidar as L
from ..frontends import vio as V
from ..fusion import engine as fu
from ..fusion import vil
from ..utils import tracing as TR
from . import diagnostics as DIAG
from . import roc as R


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment cell (scenario kind × seed × duration × knobs)."""

    kind: str = "town"          # town / corridor / tunnel / arena / field
    duration: float = 3.0
    seed: int = 0
    two_stage: bool = True
    undistort: bool = True
    emit_dists: bool = True
    distort_sweeps: bool = True
    icp_iters: int = 6
    degen_eigval: float = 5.0
    trans_threshold: float = -6.0
    rot_threshold: float = 4.0

    def key(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return (f"{self.kind}_d{self.duration:g}_s{self.seed}_"
                + hashlib.sha1(blob.encode()).hexdigest()[:10])


def default_grid(seeds: Sequence[int] = (0, 1),
                 duration: float = 60.0) -> list[ExperimentSpec]:
    """The thesis's evaluation set, reference-shaped: every run enters and
    leaves degeneracy mid-drive, so each carries positive and negative
    labels (``tunnel``: trans-degenerate middle; ``field``: open-plane
    middle third, rot and trans degenerate)."""
    return [ExperimentSpec(kind=k, duration=duration, seed=s)
            for k in ("tunnel", "field") for s in seeds]


def smoke_grid(seeds: Sequence[int] = (0, 1),
               duration: float = 3.0) -> list[ExperimentSpec]:
    """Fast tier: one cell per scenario family, including the
    always-degenerate and never-degenerate kinds."""
    return [ExperimentSpec(kind=k, duration=duration, seed=s)
            for k in ("town", "corridor", "tunnel", "arena") for s in seeds]


# The metrics scored on every run's Hessian series: spectral (d/a/e-opt,
# condition, entropy), ratio (M_now·M_prev⁻¹) and divergence (JBLD, KL)
# families of the reference's find_correlations sweep.
METRIC_NAMES = ("d_opt", "a_opt", "e_opt", "condition_number",
                "differential_entropy", "norm_frobenius",
                "d_opt_ratio", "e_opt_ratio",
                "jensen_bregman", "kullback_leibler_0cov")


def experiment_config(spec: ExperimentSpec) -> vil.VilConfig:
    """The full system's configuration for one cell: default maps and
    submaps, ``spec.icp_iters`` scan-to-map iterations with fresh
    correspondences each, the VIO's relative motion as the registration
    prior (``guess_is_delta``, which also undistorts the first sweep), and
    the per-correspondence log-det gate at the spec's thresholds."""
    vio_cfg = V.VioConfig(num_landmarks=24, update_iters=2)
    return vil.VilConfig(
        vio=vio_cfg,
        lidar=L.LidarOdomConfig(
            icp=L.IcpConfig(iters=spec.icp_iters,
                            degen_eigval=spec.degen_eigval),
            two_stage=spec.two_stage, undistort=spec.undistort,
            emit_dists=spec.emit_dists, guess_is_delta=True),
        gate=DG.GateConfig(rot_threshold=spec.rot_threshold,
                           trans_threshold=spec.trans_threshold,
                           normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12,
                                      gn_iters=4),
            sensors=vil.VilConfig().fusion.sensors, max_imu_per_gap=32),
    )


def experiment_scenario(spec: ExperimentSpec, cfg: vil.VilConfig,
                        device=DEFAULT_DEVICE) -> scenarios.VilScenario:
    """The cell's drive on ``device``, in float32."""
    return scenarios.build(spec.kind, duration=spec.duration,
                           vio_cfg=cfg.vio, dtype=torch.float32,
                           device=device, seed=spec.seed,
                           distort_sweeps=spec.distort_sweeps)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_scenario(spec: ExperimentSpec, cfg: vil.VilConfig,
                 sc: scenarios.VilScenario) -> dict:
    """Run ``cfg`` over the scenario ``sc`` through ``run_vil``, on the
    device and in the dtype of its sweeps, and score it: per-estimator
    errors against ground truth, the metric scores of the Hessian series,
    the gate's normalised and raw log-dets, and with ``spec.emit_dists``
    the six dist slopes and the 6 × S perturbation dists they come from.
    Returns the numpy result dict, which also holds each sweep's frozen
    ICP directions and each event's health and solve flags.

    Program spans (``utils.tracing``): the call is ``experiments.run_scenario``,
    its errors against ground truth ``experiments.diagnostics`` and its
    scoring ``experiments.score``; the counters
    ``icp.frozen_sweeps`` (sweeps with a frozen ICP direction) and
    ``gate.dropped_sweeps`` are counted from the numpy result."""
    with TR.span("experiments.run_scenario"):
        out = _run_scenario(spec, cfg, sc)
        TR.count("icp.frozen_sweeps",
                 int(np.any(out["icp_degenerate"] > 0, axis=-1).sum()))
        TR.count("gate.dropped_sweeps", int((out["gate_keep"] == 0).sum()))
    return out


def _run_scenario(spec: ExperimentSpec, cfg: vil.VilConfig,
                  sc: scenarios.VilScenario) -> dict:
    dtype, dev = sc.sweeps.xyz.dtype, sc.sweeps.xyz.device

    def dev_t(x):
        return torch.as_tensor(_np(x), dtype=dtype, device=dev)

    t0 = torch.zeros((), dtype=dtype, device=dev)
    pose0 = sc.traj.pose_fn(t0)
    vel0 = sc.traj.vel_fn(t0)
    zeros6 = torch.zeros(6, dtype=dtype, device=dev)
    _, res = vil.run_vil(
        cfg, sc.imu_times, sc.imu_accel, sc.imu_gyro,
        _np(sc.vio_times), sc.vio_frames,
        V.init(cfg.vio, pose0, vel0, zeros6),
        _np(sc.lidar_times), sc.sweeps,
        L.odometry.init(cfg.lidar, dtype, pose0=pose0),
        lidar_guess_from_vio_idx=_np(sc.lidar_guess_idx),
        engine_state=fu.init(cfg.fusion, pose0, vel0, zeros6, t0),
    )

    # Per-estimator diagnostics against ground truth.
    times = res.timeline.times
    with TR.span("experiments.diagnostics"):
        gt_fused = vmap(sc.traj.pose_fn)(times)
        gt_vio, gt_lidar = dev_t(sc.gt_vio_poses), dev_t(sc.gt_lidar_poses)
        diag_fused = DIAG.diagnostics(times, res.fused.poses, gt_fused)
        diag_vio = DIAG.diagnostics(dev_t(sc.vio_times), res.vio_out.pose,
                                    gt_vio)
        diag_lidar = DIAG.diagnostics(dev_t(sc.lidar_times),
                                      res.lidar_out.pose, gt_lidar)

    # Metric scores of the Hessian series, the gate's log-dets (normalised
    # per correspondence, and raw: raw = normalised + 3·log(n_corr)), and
    # the slopes of all six perturbation directions.
    hessian = res.lidar_out.hessian
    extra = {}
    with TR.span("experiments.score"):
        series = DG.score_series(METRIC_NAMES, hessian)
        scores = {n: s.score_trans for n, s in series.items()}
        scores.update({f"{n}_rot": s.score_rot for n, s in series.items()})
        scores["gate_trans_logdet"] = res.gate.trans_d_opt
        scores["gate_rot_logdet"] = res.gate.rot_d_opt
        raw = DG.logdet_gate(hessian,
                             DG.GateConfig(normalize_per_corr=False))
        scores["gate_trans_logdet_raw"] = raw.trans_d_opt
        scores["gate_rot_logdet_raw"] = raw.rot_d_opt
        if spec.emit_dists:
            d = res.lidar_out.dists
            slopes = M.dist_slopes_6dof(d.dists, d.shift_trans[0],
                                        d.shift_rot[0])          # (T, 6)
            for i, ax in enumerate(("tx", "ty", "tz", "rx", "ry", "rz")):
                scores[f"dist_slope_{ax}"] = slopes[:, i]
            extra["dists"] = _np(d.dists)                        # (T, 6, S)

    return {
        "spec": dataclasses.asdict(spec),
        "n_corr": _np(res.lidar_out.n_corr),
        "events": int(times.shape[0]),
        "ate_fused": float(DIAG.ate_rmse(res.fused.poses, gt_fused)),
        "ate_vio": float(DIAG.ate_rmse(res.vio_out.pose, gt_vio)),
        "ate_lidar": float(DIAG.ate_rmse(res.lidar_out.pose, gt_lidar)),
        "gate_keep_fraction": float(np.mean(_np(res.gate.keep))),
        "degen_windows": [list(w) for w in sc.degen_windows],
        "lidar_times": _np(sc.lidar_times),
        "vio_times": _np(sc.vio_times),
        "fused_times": _np(times),
        "err_fused": _np(diag_fused.abs_dist_err),
        "err_vio": _np(diag_vio.abs_dist_err),
        "err_lidar": _np(diag_lidar.abs_dist_err),
        "fused_poses": _np(res.fused.poses),
        "vio_poses": _np(res.vio_out.pose),
        "lidar_poses": _np(res.lidar_out.pose),
        "gt_fused_poses": _np(gt_fused),
        "gate_keep": _np(res.gate.keep),
        "icp_degenerate": _np(res.lidar_out.degenerate),         # (T, 6)
        "fused_healthy": _np(res.fused.healthy),
        "fused_solved": _np(res.fused.solved),
        "scores": {k: _np(v) for k, v in scores.items()},
        "hessian": _np(hessian),
        **extra,
    }


def _run(spec: ExperimentSpec, device=DEFAULT_DEVICE) -> dict:
    """Execute one experiment in float32 on ``device``: scenario → full
    VIL → numpy results."""
    cfg = experiment_config(spec)
    return run_scenario(spec, cfg, experiment_scenario(spec, cfg, device))


def run_experiment(spec: ExperimentSpec, cache_dir: str,
                   device=DEFAULT_DEVICE) -> dict:
    """Run (or load from the cache) one experiment; a cached run is never
    executed again, as the reference's numpified-bag pickles."""
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(spec, cache_dir)
    if os.path.exists(path):
        with np.load(path, allow_pickle=True) as z:
            def un(a):
                if a.dtype == object:
                    return a.item() if a.ndim == 0 else [list(w)
                                                         for w in a]
                return a
            return {k: un(z[k]) for k in z.files}
    out = _run(spec, device)
    save_result(out, path)
    return out


def cache_path(spec: ExperimentSpec, cache_dir: str) -> str:
    """Where :func:`run_experiment` keeps the spec's result."""
    return os.path.join(cache_dir, spec.key() + ".npz")


def save_result(out: Mapping, path: str) -> None:
    """Write a result dict as :func:`run_experiment` caches it, so a run
    made by other means (``run_scenario`` on a scenario already built) is
    loaded instead of executed again."""
    flat = dict(out)
    # npz-friendly: store dicts as object scalars.
    flat["spec"] = np.array(out["spec"], dtype=object)
    flat["scores"] = np.array(out["scores"], dtype=object)
    flat["degen_windows"] = np.array(out["degen_windows"], dtype=object)
    np.savez_compressed(path, **flat)


def run_batch(specs: Sequence[ExperimentSpec], cache_dir: str,
              device=DEFAULT_DEVICE) -> list[dict]:
    return [run_experiment(s, cache_dir, device) for s in specs]


def _labels(lt: np.ndarray, windows, kind: str) -> torch.Tensor:
    return R.label_windows(torch.as_tensor(lt), windows, kind=kind)


def report(result: Mapping, out_dir: str) -> dict:
    """Per-run report figures and AUC table (make_prettier_graphs.py's
    plot_all_rocs / plot_err_over_time). Returns the summary dict, also
    written as report.json."""
    from . import plots as P

    os.makedirs(out_dir, exist_ok=True)
    spec = dict(result["spec"])
    windows = [tuple(w) for w in list(result["degen_windows"])]
    lt = np.asarray(result["lidar_times"])
    scores = dict(result["scores"])

    P.plot_error_over_time(
        {"lidar": (result["lidar_times"], result["err_lidar"]),
         "vio": (result["vio_times"], result["err_vio"]),
         "fused": (result["fused_times"], result["err_fused"])},
        degen_windows=windows,
        title=f"{spec['kind']} seed {spec['seed']}",
        path=os.path.join(out_dir, "error_over_time.png"))
    P.plot_metric_over_time(
        lt, scores, degen_windows=windows,
        title="degeneracy metrics",
        path=os.path.join(out_dir, "metrics_over_time.png"))

    aucs, notes = {}, {}
    if windows:
        # Rot-block metrics score against DEGEN_ROT windows, everything
        # else against DEGEN_TRANS.
        lab = {k: _labels(lt, windows, k) for k in ("trans", "rot")}
        curves = {}
        for name, s in scores.items():
            labels = lab["rot"] if _is_rot_metric(name) else lab["trans"]
            if not (bool(labels.any()) and not bool(labels.all())):
                continue
            c = R.roc(labels, torch.as_tensor(np.asarray(s)),
                      low_is_degenerate=_low_is_degenerate(name))
            curves[name] = c
            aucs[name] = float(c.auc)
            note = _auc_note(name, float(c.auc))
            if note:
                notes[name] = note
        if curves:
            P.plot_rocs(curves, title="detector ROC",
                        path=os.path.join(out_dir, "roc.png"))

    if "fused_poses" in result:
        from .trajectory_view import write_view
        write_view(
            os.path.join(out_dir, "trajectory.html"),
            {"gt": (result["fused_times"], result["gt_fused_poses"]),
             "fused": (result["fused_times"], result["fused_poses"]),
             "vio": (result["vio_times"], result["vio_poses"]),
             "lidar": (result["lidar_times"], result["lidar_poses"])},
            gate_keep=result.get("gate_keep"),
            title=f"{spec['kind']} seed {spec['seed']}")

    summary = {
        "spec": spec,
        "ate_fused": float(result["ate_fused"]),
        "ate_vio": float(result["ate_vio"]),
        "ate_lidar": float(result["ate_lidar"]),
        "gate_keep_fraction": float(result["gate_keep_fraction"]),
        "auc": aucs,
        "auc_polarity": {n: ("low" if _low_is_degenerate(n) else "high")
                         for n in aucs},
        "auc_notes": notes,
    }
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _is_rot_metric(name: str) -> bool:
    # '_rot' sub-block scores, both gate rot series, and the three
    # rotational perturbation-distance slopes.
    return ("_rot" in name) or name.startswith("dist_slope_r")


# Metric polarity. The ROC convention (roc.py, the reference's calc_roc) is
# "LOW score ⇒ degenerate": right for information-volume metrics on a
# Hessian, backwards for metrics that GROW under degeneracy — the raw
# condition number and the divergence/distance family. ``condition_number``
# is already the reference's NEGATED condition number, so it stays low =
# degenerate; only ``condition_cov`` is listed here.
_HIGH_IS_DEGENERATE_BASES = frozenset({
    "condition_cov",
    "jensen_bregman", "jensen_bregman_ref",
    "correlation_matrix_distance",
    "kullback_leibler", "kullback_leibler_0pose", "kullback_leibler_0cov",
})


def _low_is_degenerate(name: str) -> bool:
    base = name[:-4] if name.endswith("_rot") else name
    return base not in _HIGH_IS_DEGENERATE_BASES


def _auc_note(name: str, auc: float) -> str | None:
    """One-line explanation for every below-chance AUC."""
    if auc >= 0.5:
        return None
    base = name[:-4] if name.endswith("_rot") else name
    if base.endswith("_ratio") or base in (
            "jensen_bregman", "jensen_bregman_ref", "kullback_leibler",
            "kullback_leibler_0pose", "kullback_leibler_0cov",
            "correlation_matrix_distance"):
        return ("transition detector: compares M_now to M_prev, so it "
                "fires at window ENTRY/EXIT edges and is near/below "
                "chance against sustained inside-window labels by "
                "construction")
    if _is_rot_metric(name) and base in (
            "d_opt", "a_opt", "gate_rot_logdet", "gate_rot_logdet_raw",
            "differential_entropy", "norm_frobenius", "max_eigen"):
        return ("rotation information is lever-arm-weighted "
                "(λ ≈ Σ|r×n|² over correspondences): open scenes whose "
                "only structure is DISTANT can carry more absolute "
                "rot-block volume than built-up ones even while yaw "
                "collapses relatively, so volume metrics (det/trace/"
                "entropy/norm) on the raw 3×3 rot block confound range "
                "with conditioning — e_opt_rot, condition_number_rot and "
                "dist_slope_r* are the robust rot detectors (measured on "
                "the field grid)")
    if not _is_rot_metric(name) and base in (
            "d_opt", "a_opt", "gate_trans_logdet", "gate_trans_logdet_raw",
            "differential_entropy", "norm_frobenius", "max_eigen"):
        return ("close-range structure confound (the trans-block twin of "
                "the rot lever-arm note): ENCLOSED degenerate scenes — "
                "tunnel walls metres from the sensor — RAISE the absolute "
                "information volume (more, closer correspondences) while "
                "starving only the along-axis DoF, so volume metrics "
                "(det/trace/entropy/norm) on the 3×3 trans block score "
                "higher inside the degenerate window than outside; e_opt "
                "and dist_slope_tx are the conditioning-sensitive trans "
                "detectors (measured on the tunnel grid)")
    if base in ("condition_number", "condition_cov"):
        return ("condition-number polarity is scene-dependent: it rises "
                "when the WEAK eigenvalue collapses but falls when "
                "degeneracy comes with the STRONG directions shrinking "
                "(e.g. structures leaving range flatten the whole "
                "spectrum); below chance here means the latter regime "
                "dominates this grid")
    if base == "a_opt":
        return ("trace is dominated by the strong directions; a single "
                "collapsing eigenvalue barely moves it, so it ranks "
                "scenes by overall point count/geometry rather than "
                "degeneracy (the reference's find_correlations saw the "
                "same weakness)")
    if base.startswith("dist_slope"):
        return ("perturbation-distance slope for a DoF the labeled "
                "windows do not starve (e.g. tz/rx/ry over a ground "
                "plane stay observable inside the windows)")
    return ("below chance under its declared polarity on this grid — "
            "anti-predictive here; kept in the table for completeness")


def _pool_scores(results: Sequence[Mapping]):
    """Concatenate every run's (scores, typed labels) over the grid — the
    pooled per-metric sample sets of plot_all_rocs
    (make_prettier_graphs.py:787-1008)."""
    pooled: dict = {}
    lab_trans, lab_rot = [], []
    for res in results:
        windows = [tuple(w) for w in list(res["degen_windows"])]
        lt = np.asarray(res["lidar_times"])
        lab_trans.append(_labels(lt, windows, "trans").numpy())
        lab_rot.append(_labels(lt, windows, "rot").numpy())
        for name, s in dict(res["scores"]).items():
            pooled.setdefault(name, []).append(np.asarray(s))
    pooled = {k: np.concatenate(v) for k, v in pooled.items()}
    return pooled, np.concatenate(lab_trans), np.concatenate(lab_rot)


def calibrate_thresholds(results: Sequence[Mapping]) -> dict:
    """Fit both gate thresholds from the grid's labeled windows: pool every
    run's normalised (and raw) log-det scores, then pick each threshold by
    Youden's J (``degeneracy.calibrate_threshold``) — the data-driven
    version of the reference's hand-tuned 11.5/28.9."""
    pooled, lab_trans, lab_rot = _pool_scores(results)
    out = {}
    for key, lab, name in (("trans_threshold", lab_trans,
                            "gate_trans_logdet"),
                           ("rot_threshold", lab_rot, "gate_rot_logdet"),
                           ("raw_trans_threshold", lab_trans,
                            "gate_trans_logdet_raw"),
                           ("raw_rot_threshold", lab_rot,
                            "gate_rot_logdet_raw")):
        s = pooled.get(name)
        if s is None or not lab.any() or lab.all():
            continue
        ok = np.isfinite(s)
        if not ok.any():
            continue
        out[key] = float(DG.calibrate_threshold(torch.as_tensor(s[ok]),
                                                torch.as_tensor(lab[ok])))
    return out


# The reference's hand-tuned raw thresholds for ITS Hessian scale
# (gtsam_fusion/config/carla/fusion_params.yaml:35-36).
REFERENCE_RAW_THRESHOLDS = {"rot": 11.5, "trans": 28.9}


def raw_threshold_parity(results: Sequence[Mapping],
                         thresholds: Mapping) -> dict:
    """The pooled calibrated raw log-det thresholds next to the
    reference's 11.5/28.9, with the scale mapping between the Hessians:
    log det(H_raw_block) = log det(H_norm_block) + 3·log(n_corr), so raw
    thresholds move with the correspondence count and only the normalised
    ones transfer between implementations."""
    n_corr = np.concatenate([np.asarray(r["n_corr"]) for r in results
                             if "n_corr" in r]) if results else np.zeros(0)
    n_corr = n_corr[n_corr > 0]
    med_n = float(np.median(n_corr)) if n_corr.size else float("nan")
    return {
        "reference_raw": dict(REFERENCE_RAW_THRESHOLDS),
        "calibrated_raw": {
            "rot": thresholds.get("raw_rot_threshold"),
            "trans": thresholds.get("raw_trans_threshold"),
        },
        "calibrated_normalized": {
            "rot": thresholds.get("rot_threshold"),
            "trans": thresholds.get("trans_threshold"),
        },
        "median_n_corr": med_n,
        "raw_minus_normalized_offset_3logn": 3.0 * float(np.log(med_n))
        if np.isfinite(med_n) and med_n > 0 else None,
        "note": "raw = normalized + 3*log(n_corr); raw thresholds are "
                "implementation-scale-specific (the reference's 11.5/28.9 "
                "presume LOAM's correspondence budget), normalized ones "
                "transfer",
    }


def aggregate_report(results: Sequence[Mapping], out_dir: str) -> dict:
    """Cross-run report (plot_all_rocs parity): one ROC figure over the
    POOLED labeled windows of every run, a cross-run AUC table, an ATE
    comparison figure and the calibrated thresholds, under ``out_dir``."""
    from . import plots as P

    os.makedirs(out_dir, exist_ok=True)
    pooled, lab_trans, lab_rot = _pool_scores(results)

    curves, aucs, notes = {}, {}, {}
    for name, s in pooled.items():
        lab = lab_rot if _is_rot_metric(name) else lab_trans
        if not (lab.any() and not lab.all()):
            continue
        c = R.roc(torch.as_tensor(lab), torch.as_tensor(s),
                  low_is_degenerate=_low_is_degenerate(name))
        curves[name] = c
        aucs[name] = float(c.auc)
        note = _auc_note(name, float(c.auc))
        if note:
            notes[name] = note
    if curves:
        P.plot_rocs(curves, title="pooled detector ROC (all runs)",
                    path=os.path.join(out_dir, "roc_all.png"))

    ate_rows = {}
    for res in results:
        spec = dict(res["spec"])
        key = f"{spec['kind']}_d{spec['duration']:g}_s{spec['seed']}"
        ate_rows[key] = {"lidar": float(res["ate_lidar"]),
                         "vio": float(res["ate_vio"]),
                         "fused": float(res["ate_fused"])}
    P.plot_ate_table(ate_rows, path=os.path.join(out_dir, "ate_table.png"))

    thresholds = calibrate_thresholds(results)
    summary = {"auc": aucs,
               "auc_polarity": {n: ("low" if _low_is_degenerate(n)
                                    else "high") for n in aucs},
               "auc_notes": notes,
               "ate": ate_rows,
               "calibrated_thresholds": thresholds,
               "raw_threshold_parity": raw_threshold_parity(results,
                                                            thresholds),
               "n_runs": len(results)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def run_and_report(specs: Sequence[ExperimentSpec], cache_dir: str,
                   report_dir: str, device=DEFAULT_DEVICE) -> list[dict]:
    """Run (cached) every spec, write its per-run report, then the
    cross-run aggregate; returns the per-run summaries (also written, with
    the aggregate, as ``report_dir/summary.json``)."""
    summaries, results = [], []
    for spec in specs:
        res = run_experiment(spec, cache_dir, device)
        results.append(res)
        summaries.append(report(res, os.path.join(report_dir, spec.key())))
    agg = aggregate_report(results, os.path.join(report_dir, "aggregate"))
    with open(os.path.join(report_dir, "summary.json"), "w") as f:
        json.dump({"runs": summaries, "aggregate": agg}, f, indent=2)
    return summaries

"""Offline evaluation plots — the L7 capability of the reference's
vil_fusion/python/make_prettier_graphs.py: per-metric score-over-time with
shaded degenerate windows, ROC curves with AUC, and estimator
error-over-time comparisons (LOAM vs ROVIO vs Fusion,
make_prettier_graphs.py:1083-1149).

matplotlib is imported lazily so headless/benchmark runs never pay for it.

The port's own copy of ``vil_sensor_fusion_tpu/eval/plots.py``
(which imports no JAX), so the port depends on nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _shade_windows(ax, windows, color=(0.2, 0.2, 0.2, 0.2)):
    """The reference's grey degenerate-region shading
    (make_prettier_graphs.py:540-545). Windows are (start, end) or
    (start, end, kind)."""
    for w in windows:
        ax.axvspan(float(w[0]), float(w[1]), color=color)


def plot_metric_over_time(
    times: np.ndarray,
    scores: Mapping[str, np.ndarray],
    degen_windows: Sequence[tuple] = (),
    title: str = "",
    path: str | None = None,
):
    plt = _plt()
    fig, axes = plt.subplots(
        len(scores), 1, figsize=(10, 2.2 * len(scores)), sharex=True,
        squeeze=False)
    for ax, (name, y) in zip(axes[:, 0], scores.items()):
        ax.plot(np.asarray(times), np.asarray(y), lw=0.8)
        ax.set_ylabel(name, fontsize=8)
        _shade_windows(ax, degen_windows)
    axes[-1, 0].set_xlabel("time [s]")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_ate_table(
    rows: Mapping[str, Mapping[str, float]],
    title: str = "ATE RMSE by run [m]",
    path: str | None = None,
):
    """Cross-run ATE comparison bar chart: one group per run, one bar per
    estimator (LOAM vs ROVIO vs Fusion — the summary role of
    make_prettier_graphs.py:1083-1149's per-dataset comparisons)."""
    plt = _plt()
    run_names = list(rows.keys())
    est_names = sorted({e for r in rows.values() for e in r})
    x = np.arange(len(run_names))
    w = 0.8 / max(len(est_names), 1)
    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(run_names)), 3.5))
    for k, est in enumerate(est_names):
        vals = [rows[r].get(est, np.nan) for r in run_names]
        ax.bar(x + (k - (len(est_names) - 1) / 2) * w, vals, w, label=est)
    ax.set_xticks(x)
    ax.set_xticklabels(run_names, rotation=30, ha="right", fontsize=7)
    ax.set_ylabel("ATE RMSE [m]")
    ax.legend(fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_rocs(
    curves: Mapping[str, tuple],
    title: str = "",
    path: str | None = None,
):
    """curves: name -> RocCurve (or (fpr, tpr, auc))."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    for name, c in curves.items():
        fpr = np.asarray(getattr(c, "fpr", c[0]))
        tpr = np.asarray(getattr(c, "tpr", c[1]))
        auc = float(getattr(c, "auc", c[2]))
        ax.plot(fpr, tpr, label=f"{name} (AUC {auc:.3f})", lw=1.2)
    ax.plot([0, 1], [0, 1], "k--", lw=0.6)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend(fontsize=7)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_error_over_time(
    series: Mapping[str, tuple],
    degen_windows: Sequence[tuple] = (),
    title: str = "",
    path: str | None = None,
):
    """series: estimator name -> (times, abs_dist_err) — the LOAM vs ROVIO
    vs Fusion comparison figure."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 4))
    for name, (t, e) in series.items():
        ax.plot(np.asarray(t), np.asarray(e), label=name, lw=1.0)
    _shade_windows(ax, degen_windows)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("absolute position error [m]")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig

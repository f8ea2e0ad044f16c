"""Parity of the port's degeneracy library (``degeneracy/metrics.py``,
``gate.score_series``, ``gate.calibrate_threshold``) with the JAX package,
in float64 on identical numpy inputs.

The batches mix random SPD matrices with the two singular cases a run
meets: the all-zero Hessian of the map-seeding first sweep, and a rank-2
matrix (an SPD 2×2 block in rows/columns 0 and 3, zero elsewhere, so its
LU pivots are exactly zero in either library). Their NaN and ±inf pattern
is part of the result (the pooled AUC of a series with a NaN is 0), so the
masks must be identical; finite values agree to rtol 1e-10 (atol 1e-12 for
values that are round-off around zero, such as eigenvalues of a singular
matrix). The Youden-J threshold is equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import degeneracy as JD
from vil_sensor_fusion_tpu.degeneracy import gate as JG
from vil_sensor_fusion_tpu.degeneracy import metrics as JM
from vil_sensor_fusion_tpu_torch import degeneracy as TD
from vil_sensor_fusion_tpu_torch.degeneracy import gate as TG
from vil_sensor_fusion_tpu_torch.degeneracy import metrics as TM


def assert_same(t, j, rtol=1e-10, atol=1e-12, msg=""):
    """Identical NaN / +inf / -inf masks, finite values within tolerance."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (msg, t.shape, j.shape)
    for mask in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(mask(t), mask(j), err_msg=msg)
    f = np.isfinite(j)
    np.testing.assert_allclose(t[f], j[f], rtol=rtol, atol=atol,
                               err_msg=msg)


def _spd(rng, batch, n=6):
    A = rng.standard_normal(batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)


def _zero():
    return np.zeros((6, 6))


def _rank2():
    m = np.zeros((6, 6))
    m[np.ix_([0, 3], [0, 3])] = [[4.0, 1.0], [1.0, 3.0]]
    return m


def _pairs():
    """(now, prev, pose_now, pose_prev): every pairing of SPD, zero and
    rank-2 matrices, both ways round."""
    rng = np.random.default_rng(0)
    spd = _spd(rng, (6,))
    z, r2 = _zero(), _rank2()
    now = np.stack([spd[0], spd[1], z, r2, spd[2], z, r2, spd[3], z, r2,
                    spd[4]])
    prev = np.stack([np.eye(6), spd[5], spd[0], spd[1], z, z, r2, r2, r2, z,
                     np.eye(6)])
    return (now, prev, rng.standard_normal((11, 6)),
            rng.standard_normal((11, 6)))


@pytest.mark.parametrize("name", sorted(JM.METRICS))
def test_metric_matches_jax(name):
    now, prev, pn, pp = _pairs()
    for block in (slice(0, 6), slice(0, 3), slice(3, 6)):
        a, b = now[:, block, block], prev[:, block, block]
        kw = dict(pose_now=pn[:, block], pose_prev=pp[:, block])
        j = JM.METRICS[name](mat_now=jnp.asarray(a), mat_prev=jnp.asarray(b),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        t = TM.METRICS[name](mat_now=torch.from_numpy(a),
                             mat_prev=torch.from_numpy(b),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert_same(t, j, msg=f"{name} block {block}")


def test_singular_matrices_give_the_jax_nan_pattern():
    """The cases the first sweep meets: inverses of the zero Hessian are
    NaN (not an exception), eigen/singular values of the non-finite
    matrices this produces are all NaN, and the ratio metrics at t = 1
    come out NaN as in JAX."""
    z = torch.zeros(2, 6, 6, dtype=torch.float64)
    inv = TM._inv(z)
    assert_same(inv, jnp.linalg.inv(jnp.zeros((2, 6, 6))))
    # Non-finite matrices as a run makes them: an inverse of the zero
    # Hessian (NaN with one +inf), and an inf entry.
    bad = torch.eye(6, dtype=torch.float64).repeat(3, 1, 1)
    bad[1] = inv[0]
    bad[2, 0, 1] = bad[2, 1, 0] = torch.inf
    assert_same(TM._eigvalsh(bad), jnp.linalg.eigvalsh(jnp.asarray(
        bad.numpy())))
    assert_same(TM._svdvals(bad), jnp.linalg.svd(jnp.asarray(bad.numpy()),
                                                 compute_uv=False))
    spd = torch.from_numpy(_spd(np.random.default_rng(1), (2,)))
    for name in ("d_opt_ratio", "e_opt_ratio", "jensen_bregman",
                 "kullback_leibler_0cov"):
        v = TM.METRICS[name](mat_now=spd, mat_prev=z)
        j = JM.METRICS[name](mat_now=jnp.asarray(spd.numpy()),
                             mat_prev=jnp.zeros((2, 6, 6)))
        assert_same(v, j, msg=name)


def _series(rng, T=9):
    mats = _spd(rng, (T,))
    mats[0] = _zero()          # the map-seeding first sweep
    mats[4] = _rank2()
    mats[6] = _zero()
    return mats


@pytest.mark.parametrize("with_poses", [False, True])
def test_score_series_matches_jax(with_poses):
    rng = np.random.default_rng(2)
    mats = _series(rng)
    poses = rng.standard_normal((9, 6)) if with_poses else None
    names = sorted(JM.METRICS)
    sj = JG.score_series(names, jnp.asarray(mats),
                         None if poses is None else jnp.asarray(poses))
    st = TG.score_series(names, torch.from_numpy(mats),
                         None if poses is None else torch.from_numpy(poses))
    assert set(st) == set(sj)
    for name in names:
        for field in JG.DegeneracyScores._fields:
            assert_same(getattr(st[name], field), getattr(sj[name], field),
                        msg=f"{name}.{field}")


def test_calibrate_threshold_matches_jax():
    """Ties, -inf (an empty Hessian's log-det) and NaN in the scores; the
    stable sort and the first best cut must pick JAX's threshold."""
    rng = np.random.default_rng(3)
    base = np.round(rng.normal(0.0, 1.0, 60), 1)         # many exact ties
    lab = (base + rng.normal(0.0, 0.7, 60)) < -0.2
    for case in range(4):
        s = base.copy()
        if case >= 1:
            s[[0, 17, 33]] = -np.inf
        if case >= 2:
            s[[5, 40]] = np.nan
        if case == 3:
            s[:] = np.round(s, 0)                        # ties everywhere
        j = JG.calibrate_threshold(jnp.asarray(s), jnp.asarray(lab))
        t = TG.calibrate_threshold(torch.from_numpy(s), torch.from_numpy(lab))
        assert float(t) == float(j), (case, float(t), float(j))
    # All labels of one class, and a float32 series.
    s32 = base.astype(np.float32)
    for labels in (np.zeros(60, bool), lab):
        j = JG.calibrate_threshold(jnp.asarray(s32), jnp.asarray(labels))
        t = TG.calibrate_threshold(torch.from_numpy(s32),
                                   torch.from_numpy(labels))
        assert float(t) == float(j)


def test_dist_slopes_match_jax():
    rng = np.random.default_rng(4)
    shifts = np.linspace(0.0, 0.2, 15)
    d = rng.uniform(0.0, 1.0, (5, 6, 15)) + shifts * rng.uniform(0, 3, (5, 6,
                                                                       1))
    j = JM.dist_slopes_6dof(jnp.asarray(d), jnp.asarray(shifts),
                            jnp.asarray(shifts * 0.5))
    t = TM.dist_slopes_6dof(torch.from_numpy(d), torch.from_numpy(shifts),
                            torch.from_numpy(shifts * 0.5))
    assert_same(t, j)
    flat = np.zeros((2, 15))                             # zero shifts: no NaN
    assert_same(TM.dist_slope(torch.from_numpy(flat), torch.from_numpy(flat)),
                JM.dist_slope(jnp.asarray(flat), jnp.asarray(flat)))


def test_exports_match_jax():
    assert set(TD.__all__) == set(JD.__all__)
    assert list(TD.METRICS) == list(JD.METRICS)
    assert TG.DegeneracyScores._fields == JG.DegeneracyScores._fields


def test_scores_stay_on_the_matrices_device_and_dtype():
    mats = torch.from_numpy(_series(np.random.default_rng(5))).float()
    out = TG.score_series(["d_opt", "e_opt_ratio", "kullback_leibler_0cov"],
                          mats)
    for s in out.values():
        for v in s:
            assert v.dtype == torch.float32 and v.device == mats.device

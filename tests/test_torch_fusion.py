"""Parity of the port's fusion back-end with the JAX package, in float64 on
identical numpy inputs: IMU preintegration, the fixed-lag smoother
(add_keyframe with its FEJ Schur eviction, add_between, solve), the log-det
gate, and the whole engine on a small two-sensor timeline.

Same algorithm and f64 on both sides, so values agree to round-off; the
tolerances (1e-8 and tighter) leave room for the different summation
orders of the two libraries' einsums and Cholesky solves."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu import graph as JG
from vil_sensor_fusion_tpu.core import preintegration as JP
from vil_sensor_fusion_tpu.data import synthetic as JS
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.graph import factors as JFA
from vil_sensor_fusion_tpu.graph import smoother as JSM
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch import fusion as TFU
from vil_sensor_fusion_tpu_torch.core import preintegration as TP
from vil_sensor_fusion_tpu_torch.degeneracy import gate as TDG
from vil_sensor_fusion_tpu_torch.graph import factors as TFA
from vil_sensor_fusion_tpu_torch.graph import smoother as TSM

DT = jnp.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files side by side, one
    worker each, and these tests run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _close(a, b, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _tree_close(tt, tj, **kw):
    for name in tj._fields:
        a, b = getattr(tt, name), getattr(tj, name)
        if isinstance(b, tuple):
            _tree_close(a, b, **kw)
        else:
            _close(a.numpy(), b, **kw)


def _tiny_problem(n_events=12, n_imu=128):
    """The __graft_entry__._tiny_problem timeline (circle drive, 2 sensors,
    f64) as JAX arrays, plus its config and initial engine state."""
    traj = JS.circle(radius=10.0, period=10.0)
    imu_t = jnp.arange(n_imu, dtype=DT) / 100.0
    imu = JS.sample_imu(traj, imu_t)
    n_vio = n_events * 2 // 3
    n_lid = n_events - n_vio
    t_vio = (jnp.arange(n_vio, dtype=DT) + 1.0) / 20.0
    t_lid = (jnp.arange(n_lid, dtype=DT) + 1.0) / 10.0
    vio = JS.sample_odometry(traj, t_vio)
    lid = JS.sample_odometry(traj, t_lid)
    tl = JFU.merge_timeline([
        (np.asarray(t_vio), np.asarray(vio.poses), np.asarray(vio.cov),
         np.ones(n_vio)),
        (np.asarray(t_lid), np.asarray(lid.poses), np.asarray(lid.cov),
         np.ones(n_lid)),
    ])
    cfg = JFU.FusionConfig(
        smoother=JG.SmootherConfig(window=4, between_slots=8, gn_iters=3),
        sensors=(JFU.SensorSpec(name="vio", optimize_after_odom=True),
                 JFU.SensorSpec(name="lidar", optimize_after_odom=False)),
        max_imu_per_gap=16)
    t0 = jnp.zeros((), DT)
    es = JFU.init(cfg, traj.pose_fn(t0), traj.vel_fn(t0), jnp.zeros(6, DT), t0)
    return cfg, es, tl, imu


@pytest.fixture(scope="module")
def tiny_run():
    """The tiny problem and JAX's ``run`` on it, compiled once for any
    timeline of its shapes."""
    cfg, es, tl, imu = _tiny_problem()
    run = jax.jit(lambda es, tl: JFU.run(
        cfg, es, tl, imu.times, imu.accel, imu.gyro))
    return cfg, es, tl, imu, run


@pytest.fixture(scope="module")
def tiny(tiny_run):
    cfg, es, tl, imu, run = tiny_run
    es_j, out_j = run(es, tl)
    return cfg, es, tl, imu, es_j, out_j


def _imu_stream():
    rng = np.random.default_rng(4)
    t = np.arange(300) / 200.0
    acc = np.array([0.3, -0.2, 9.81]) + 0.5 * rng.standard_normal((300, 3))
    gyr = 0.2 * rng.standard_normal((300, 3))
    return t, acc, gyr


@pytest.mark.parametrize("window", [(0.1, 0.2), (0.0123, 0.0871),
                                    (1.40, 1.60), (0.5, 0.5004)])
def test_preintegrate_window_matches_jax(window):
    t, acc, gyr = _imu_stream()
    bias = np.array([0.01, -0.02, 0.03, 0.001, 0.002, -0.001])
    params = JP.ImuParams()
    args = (t, acc, gyr, np.float64(window[0]), np.float64(window[1]), bias)
    pj = JP.preintegrate_window(*map(jnp.asarray, args), params,
                                max_samples=48)
    pt = TP.preintegrate_window(*(torch.as_tensor(np.asarray(a))
                                  for a in args), _t(params),
                                max_samples=48)
    _tree_close(pt, pj)
    _close(TP.combined_covariance_15(pt, _t(params)).numpy(),
           JP.combined_covariance_15(pj, params))


def test_logdet_gate_matches_jax():
    rng = np.random.default_rng(8)
    J = rng.standard_normal((6, 200, 6)) * rng.uniform(0.01, 3, (6, 1, 6))
    H = np.einsum("bqi,bqj->bij", J, J)
    H[0] = 0.0                                    # empty first-sweep Hessian
    n = rng.uniform(50, 500, 6)
    for cfg in (JDG.GateConfig(),
                JDG.GateConfig(4.0, -6.0, normalize_per_corr=True)):
        gj = JDG.logdet_gate(jnp.asarray(H), cfg, n_corr=jnp.asarray(n))
        gt = TDG.logdet_gate(torch.from_numpy(H), _t(cfg),
                             n_corr=torch.from_numpy(n))
        for name in gj._fields:
            np.testing.assert_allclose(getattr(gt, name).numpy(),
                                       np.asarray(getattr(gj, name)),
                                       rtol=1e-12)


def test_engine_run_matches_jax(tiny):
    cfg, es, tl, imu, es_j, out_j = tiny
    es_t, out_t = TFU.run(_t(cfg), _t(es), _t(tl), *_t(tuple(imu)))
    _tree_close(out_t, out_j)
    _tree_close(es_t.smoother.states, es_j.smoother.states)
    _close(es_t.smoother.prior_H.numpy(), es_j.smoother.prior_H, rtol=1e-7,
           atol=1e-6)
    # The solve cadence: solves exactly on the arrived VIO events.
    np.testing.assert_array_equal(out_t.solved.numpy(),
                                  (np.asarray(tl.source) == 0) * 1.0)


def test_smoother_keyframe_between_solve_match_jax(tiny):
    """From the engine's final state: one more keyframe (FEJ Schur eviction
    of slot 0, with its 1e-7 damping), one between-factor, one solve (1e-9
    damping) — the two damping constants enter exactly as in the JAX
    package, or the Schur complement moves well beyond round-off."""
    cfg, _, _, imu, es_j, _ = tiny
    scfg = cfg.smoother
    s_j = es_j.smoother
    t_prev = float(s_j.times[-1])
    pim = jax.jit(lambda t0, t1, b: JP.preintegrate_window(
        imu.times, imu.accel, imu.gyro, t0, t1, b, scfg.imu,
        max_samples=16))(s_j.times[-1], jnp.asarray(t_prev + 0.05),
                         s_j.states.biases[-1])
    s_j2 = jax.jit(lambda s, t, p: JSM.add_keyframe(scfg, s, t, p))(
        s_j, jnp.asarray(t_prev + 0.05), pim)
    s_t2 = TSM.add_keyframe(_t(scfg), _t(s_j), torch.tensor(t_prev + 0.05,
                                                           dtype=torch.float64),
                            _t(pim))
    _close(s_t2.prior_H.numpy(), s_j2.prior_H, rtol=1e-7, atol=1e-6)
    _close(s_t2.prior_g.numpy(), s_j2.prior_g, rtol=1e-7, atol=1e-6)
    _tree_close(s_t2.states, s_j2.states)
    _tree_close(s_t2.prior_lin, s_j2.prior_lin)

    meas = np.array([1.0, 0.0, 0.0, 0.01, 0.02, 0.01, 0.0])
    meas[:4] /= np.linalg.norm(meas[:4])
    cov = np.diag([0.01] * 3 + [0.001] * 3)
    a = (jnp.asarray(1, jnp.int32), jnp.asarray(3, jnp.int32),
         jnp.asarray(meas), jnp.asarray(cov), jnp.asarray(1.0))
    s_j3 = jax.jit(lambda s, *a: JSM.solve(
        scfg, JSM.add_between(scfg, s, *a)))(s_j2, *a)
    s_t3 = TSM.solve(_t(scfg), TSM.add_between(_t(scfg), s_t2, *_t(a)))
    for name in ("btw_i", "btw_j", "btw_meas", "btw_info", "btw_valid",
                 "btw_next"):
        _close(getattr(s_t3, name).numpy(), getattr(s_j3, name), rtol=1e-9)
    _tree_close(s_t3.states, s_j3.states, rtol=1e-8, atol=1e-9)
    assert TSM.SmootherConfig().damping == JSM.SmootherConfig().damping == 1e-9


@pytest.fixture(scope="module")
def jax_cost():
    """JAX's ``smoother.cost`` compiled once for the file's cost tests
    (eager, each of its many small ops is dispatched on its own)."""
    return jax.jit(JSM.cost, static_argnums=0)


@pytest.mark.parametrize("anchor", [False, True], ids=["plain", "anchor"])
def test_smoother_cost_matches_jax(tiny, jax_cost, anchor):
    """``smoother.cost`` (prior + IMU + between + unary terms) at the
    engine's final state, with one unary anchor added in the second case,
    and at a perturbed state."""
    cfg, _, _, _, es_j, _ = tiny
    scfg = cfg.smoother
    s_j = es_j.smoother
    if anchor:
        meas = np.asarray(s_j.states.poses[2]).copy()
        meas[4:7] += [0.05, -0.02, 0.01]
        s_j = JSM.add_unary(scfg, s_j, jnp.asarray(2, jnp.int32),
                            jnp.asarray(meas), 0.01 * jnp.eye(6, dtype=DT),
                            jnp.asarray(1.0))
    moved = s_j._replace(states=s_j.states._replace(
        vels=s_j.states.vels + 0.1))
    for s in (s_j, moved):
        cj = float(jax_cost(scfg, s))
        ct = TSM.cost(_t(scfg), _t(s))
        assert ct.dtype == torch.float64 and ct.shape == ()
        assert abs(float(ct) - cj) <= 1e-9 * max(abs(cj), 1.0), (ct, cj)
    assert float(jax_cost(scfg, moved)) > float(jax_cost(scfg, s_j))


def test_non_pd_covariance_gives_nan_not_an_exception():
    """torch.linalg.cholesky raises on a matrix that is not positive
    definite; jnp.linalg.cholesky returns NaN. The port keeps the NaN."""
    cov = np.diag([0.01, 0.01, -0.01, 0.01, 0.01, 0.01])
    info_j = np.asarray(JFA.info_from_cov(jnp.asarray(cov)))
    info_t = TFA.info_from_cov(torch.from_numpy(cov)).numpy()
    assert np.isnan(info_j).any() and np.isnan(info_t).any()
    np.testing.assert_array_equal(np.isnan(info_t), np.isnan(info_j))
    Hs = np.eye(4)
    Hs[3, 3] = -1.0
    xj = np.asarray(JSM._jacobi_solve(jnp.asarray(Hs), jnp.ones(4), 1e-9))
    xt = TSM._jacobi_solve(torch.from_numpy(Hs), torch.ones(4,
                                                           dtype=torch.float64),
                           1e-9).numpy()
    assert np.isnan(xj).all() and np.isnan(xt).all()


def test_engine_run_matches_jax_with_gate_dropped_events(tiny_run):
    """The degeneracy gate drops a LiDAR sweep and a VIO event: neither
    adds a factor, the dropped VIO event does not solve, and the LiDAR
    source never solves after its odometry."""
    cfg, es, tl, imu, run = tiny_run
    source = np.asarray(tl.source)
    keep = np.asarray(tl.keep).copy()
    keep[[np.nonzero(source == 1)[0][1], np.nonzero(source == 0)[0][2]]] = 0
    tl = tl._replace(keep=jnp.asarray(keep))
    es_j, out_j = run(es, tl)
    es_t, out_t = TFU.run(_t(cfg), _t(es), _t(tl), *_t(tuple(imu)))
    _tree_close(out_t, out_j)
    _tree_close(es_t.smoother.states, es_j.smoother.states)
    np.testing.assert_array_equal(out_t.solved.numpy(),
                                  ((source == 0) & (keep > 0.5)) * 1.0)


def test_health_guard_rejects_nan_event_like_jax():
    """A non-PD pose covariance on a use_pose_covariance source NaNs the
    solve; the health guard rejects that event on both sides and the
    trajectory continues identically."""
    cfg, es, tl, imu = _tiny_problem(n_events=9, n_imu=96)
    cfg = cfg._replace(sensors=(cfg.sensors[0]._replace(
        use_pose_covariance=True), cfg.sensors[1]))
    cov = np.asarray(tl.odo_cov).copy()
    bad = int(np.nonzero(np.asarray(tl.source) == 0)[0][3])
    cov[bad] = np.diag([0.01, 0.01, -0.01, 0.01, 0.01, 0.01])
    tl = tl._replace(odo_cov=jnp.asarray(cov))
    _, out_j = jax.jit(lambda es, tl: JFU.run(
        cfg, es, tl, imu.times, imu.accel, imu.gyro))(es, tl)
    _, out_t = TFU.run(_t(cfg), _t(es), _t(tl), *_t(tuple(imu)))
    h = out_t.healthy.numpy()
    assert h[bad] == 0.0 and h.sum() == len(h) - 1
    np.testing.assert_array_equal(h, np.asarray(out_j.healthy))
    assert np.isfinite(out_t.poses.numpy()).all()
    _close(out_t.poses.numpy(), out_j.poses)


@pytest.mark.parametrize("bad", ["none", "nan_vel", "fast", "bias_gyro"])
def test_health_probes_match_jax(bad):
    """finite_fraction, all_finite, check_state, guarded_update and
    wrap_step give the JAX package's verdicts and selections."""
    from vil_sensor_fusion_tpu.utils import health as JH
    from vil_sensor_fusion_tpu_torch.utils import health as TH

    vel = np.array([3.0, -1.0, 0.5])
    bias = np.array([0.1, 0.0, -0.1, 0.01, 0.02, 0.0])
    cov = np.eye(6)
    if bad == "nan_vel":
        vel[1] = np.nan
    elif bad == "fast":
        vel[0] = 150.0
    elif bad == "bias_gyro":
        bias[4] = 2.0
    tree = (vel, bias, cov, np.arange(3))
    tj, tt = tuple(map(jnp.asarray, tree)), _t(tree)
    _close(TH.finite_fraction(tt).numpy(), JH.finite_fraction(tj), rtol=1e-7)
    assert bool(TH.all_finite(tt)) == bool(JH.all_finite(tj))
    hj = JH.check_state(tj[0], tj[1], extra_tree=tj[2])
    ht = TH.check_state(tt[0], tt[1], extra_tree=tt[2])
    assert bool(ht) == bool(hj) == (bad == "none")
    prev = (np.zeros(3), np.ones(6))
    gj = JH.guarded_update(tuple(map(jnp.asarray, prev)), tj[:2], hj)
    gt = TH.guarded_update(_t(prev), tt[:2], ht)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def step(state, x):
        return [state[0] + x, state[1]], x

    sj, okj, xj = JH.wrap_step(step, lambda s: JH.check_state(*s))(
        list(tj[:2]), 1.0)
    st, okt, xt = TH.wrap_step(step, lambda s: TH.check_state(*s))(
        list(tt[:2]), 1.0)
    assert bool(okt) == bool(okj) and xt == xj
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

"""The port's full-batch f64 oracle (``graph/batch.py``) against the JAX
``solve_batch`` on ``tests/test_batch_oracle.py``'s circle problem, cut
from 12 s to 3 s (91 states, up to 88 between-factors), and the port's own
fixed-lag ``fusion.run`` against it over 1 s of the noisy problem (the
engine's eager steps cost ~0.5-1 s per event on a CPU).

Tolerances: f64 on both sides and the same Gauss-Newton; only the order of
the sums in the assembly differs (a scatter-add against a loop over
factors), so poses, velocities and biases are held to 1e-9 (measured
1.4e-14), ``n_between`` exactly and the cost to 1e-9 relative. The problem
is stiff: where a VIO and a LiDAR event share a stamp, the IMU factor
spans no time and its information reaches 1e18, so a 4e-7 error in
gravity (an f32 constant) moved the solution by 4.9e-8; 1e-9 sees that.
The fixed-lag gaps are ``test_batch_oracle.py``'s bounds, set for 12 s
(the gap grows with time)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu import graph as JG
from vil_sensor_fusion_tpu.data import synthetic as JSYN
from vil_sensor_fusion_tpu.graph import batch as JB
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch import fusion as TFU
from vil_sensor_fusion_tpu_torch.data import synthetic as TSYN
from vil_sensor_fusion_tpu_torch.graph import batch as TB

DT = jnp.float64
DUR = 3.0
FIXED_LAG_DUR = 1.0
IMU_HZ = 200.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files side by side, one
    worker each, and these tests run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(noise=0.0, seed=0, use_pose_covariance=False, drop=(),
             dur=DUR):
    """``test_batch_oracle.py``'s ``_problem`` over ``dur`` seconds. With
    ``use_pose_covariance`` the LiDAR factors take the timeline's pose
    covariance; ``drop`` marks those LiDAR events as not arrived (the gap
    gate then drops the next LiDAR factor too)."""
    rng = np.random.default_rng(seed)
    traj = JSYN.circle(radius=10.0, period=20.0)
    t_imu = jnp.arange(int(dur * IMU_HZ) + 20, dtype=DT) / IMU_HZ
    imu = JSYN.sample_imu(traj, t_imu)
    t_vio = (jnp.arange(int(dur * 20.0), dtype=DT) + 1.0) / 20.0
    t_lid = (jnp.arange(int(dur * 10.0), dtype=DT) + 1.0) / 10.0
    vio = JSYN.sample_odometry(traj, t_vio)
    lid = JSYN.sample_odometry(traj, t_lid)
    vp = np.asarray(vio.poses).copy()
    lp = np.asarray(lid.poses).copy()
    vp[:, 4:7] += rng.normal(0, noise, vp[:, 4:7].shape)
    lp[:, 4:7] += rng.normal(0, noise, lp[:, 4:7].shape)
    keep = np.ones(len(t_lid))
    keep[list(drop)] = 0.0
    lid_cov = np.asarray(lid.cov) * (1.0 + np.arange(len(t_lid)))[:, None,
                                                                    None]
    tl = JFU.merge_timeline([
        (np.asarray(t_vio), vp, np.asarray(vio.cov), np.ones(len(t_vio))),
        (np.asarray(t_lid), lp, lid_cov, keep),
    ])
    cfg = JFU.FusionConfig(
        smoother=JG.SmootherConfig(window=6, between_slots=12, gn_iters=5),
        sensors=(
            JFU.SensorSpec(name="vio", optimize_after_odom=True,
                           covariance_linear=0.02, covariance_angular=0.02,
                           max_time_skip=0.2),
            JFU.SensorSpec(name="lidar", optimize_after_odom=False,
                           covariance_linear=0.02, covariance_angular=0.02,
                           max_time_skip=0.3,
                           use_pose_covariance=use_pose_covariance),
        ),
        max_imu_per_gap=32,
    )
    t0 = jnp.zeros((), DT)
    init = (traj.pose_fn(t0).astype(DT), traj.vel_fn(t0).astype(DT),
            jnp.zeros(6, DT))
    return cfg, tl, imu, init, traj


def _solve_both(cfg, tl, imu, init):
    sj = JB.solve_batch(cfg, tl, imu.times, imu.accel, imu.gyro, *init, 0.0)
    tt = lambda x: convert.to_torch(x, "cpu", torch.float64)  # noqa: E731
    st = TB.solve_batch(convert.to_torch(cfg, "cpu"), tt(tl), tt(imu.times),
                        tt(imu.accel), tt(imu.gyro), *map(tt, init), 0.0)
    return sj, st


@pytest.mark.parametrize("noise, seed, pose_cov, drop", [
    pytest.param(0.0, 0, False, (), id="clean"),
    # Noisy odometry, the LiDAR factors on the timeline's pose covariance,
    # and two dropped LiDAR events.
    pytest.param(0.05, 3, True, (7, 8), id="noisy-pose-cov-dropped"),
])
def test_solve_batch_matches_jax(noise, seed, pose_cov, drop):
    cfg, tl, imu, init, _ = _problem(noise, seed, pose_cov, drop)
    sj, st = _solve_both(cfg, tl, imu, init)
    assert st.n_between == sj.n_between
    for f in ("poses", "vels", "biases", "times"):
        got = getattr(st, f)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(sj, f)),
                                   rtol=0, atol=1e-9, err_msg=f)
    assert abs(st.cost - sj.cost) <= 1e-9 * max(abs(sj.cost), 1.0)
    n_evt = len(np.asarray(tl.times))
    if drop:
        # Two dropped LiDAR events: their own factors and, by the 0.3 s
        # gap gate, the next arrival's one do not exist.
        assert st.n_between == n_evt - 2 - 3
    else:
        assert st.n_between == n_evt - 2


def test_solve_batch_casts_f32_inputs_to_f64():
    """JAX casts every input to f64 under x64; the port does the same for
    f32 tensors, so an f32 caller gets the f64 solve of the f32-rounded
    inputs."""
    cfg, tl, imu, init, _ = _problem(0.0, 0)
    c = convert.to_torch(cfg, "cpu")
    args = (tl, imu.times, imu.accel, imu.gyro, *init)
    t32 = lambda x: convert.to_torch(x, "cpu", torch.float32)  # noqa: E731
    s32 = TB.solve_batch(c, *map(t32, args), 0.0)
    rounded = lambda x: convert.to_torch(  # noqa: E731
        convert.to_numpy(t32(x)), "cpu", torch.float64)
    s64 = TB.solve_batch(c, *map(rounded, args), 0.0)
    assert s32.poses.dtype == torch.float64
    assert s32.n_between == s64.n_between
    for f in ("poses", "vels", "biases", "times"):
        assert torch.equal(getattr(s32, f), getattr(s64, f)), f
    assert s32.cost == s64.cost


def _fixed_lag(cfg, tl, imu, init):
    tt = lambda x: convert.to_torch(x, "cpu", torch.float64)  # noqa: E731
    c = convert.to_torch(cfg, "cpu")
    pose0, vel0, bias0 = map(tt, init)
    es = TFU.init(c, pose0, vel0, bias0, torch.zeros((), dtype=torch.float64))
    _, out = TFU.run(c, es, tt(tl), tt(imu.times), tt(imu.accel),
                     tt(imu.gyro))
    sol = TB.solve_batch(c, tt(tl), tt(imu.times), tt(imu.accel),
                         tt(imu.gyro), pose0, vel0, bias0, 0.0)
    d = np.linalg.norm(out.poses.numpy()[:, 4:7] - sol.poses.numpy()[1:, 4:7],
                       axis=-1)
    return d, sol


def test_gap_bounded_under_noise():
    """The port's streaming fixed-lag trajectory against the port's own f64
    full-batch MAP: with noisy odometry the latest-state gap stays within
    the odometry noise, and the batch solution tracks the ground truth.
    (The clean problem's tighter bound is checked on the card, over 1.5 s,
    by ``chip_smoke.py``'s phase 10.)"""
    cfg, tl, imu, init, _ = _problem(noise=0.05, seed=3,
                                     dur=FIXED_LAG_DUR)
    d, sol = _fixed_lag(cfg, tl, imu, init)
    assert float(np.mean(d)) < 0.12, np.mean(d)
    assert float(d.max()) < 0.35, d.max()
    # The port's own ground truth of the same circle at the same stamps.
    gt = TSYN.sample_ground_truth(TSYN.circle(radius=10.0, period=20.0),
                                  torch.as_tensor(np.asarray(tl.times)))
    e_b = np.linalg.norm(sol.poses.numpy()[1:, 4:7]
                         - gt.poses.numpy()[:, 4:7], axis=-1)
    assert float(e_b.mean()) < 0.08


def test_timeline_structure_matches_jax():
    """Dropped (keep 0) and invalid (valid 0) events, a gap longer than a
    sensor's max_time_skip, and a source's first arrival."""
    cfg, tl, _, _, _ = _problem(0.0, 0)
    n = len(np.asarray(tl.times))
    keep = np.ones(n)
    keep[[3, 4, 10]] = 0.0
    valid = np.ones(n)
    valid[[20, 21, 22, 40]] = 0.0
    times = np.asarray(tl.times).copy()
    times[50:] += 0.25                        # a gap past both skips
    tl = tl._replace(keep=jnp.asarray(keep), valid=jnp.asarray(valid),
                     times=jnp.asarray(times))
    for t0 in (0.0, -0.5):
        want = JB._timeline_structure(cfg, tl, t0)
        got = TB._timeline_structure(convert.to_torch(cfg, "cpu"),
                                     convert.to_torch(tl, "cpu"), t0)
        assert [tuple(map(int, b)) for b in got] == \
            [tuple(map(int, b)) for b in want]
        assert 0 < len(got) < n - 2

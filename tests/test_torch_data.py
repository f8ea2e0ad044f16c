"""Parity of the port's synthetic data (``data/``) with the JAX package:
raycast VLP-16 sweeps from the same ``World`` arrays, and IMU / odometry
streams sampled along the same analytic trajectory, in float64.

Tolerances: both sides evaluate the same closed forms in f64, so values
agree to ~1e-9. A ray that grazes a box edge could in principle flip hit
and miss on an ulp; the poses below keep every ray clear of that, so the
hit masks must match exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import raycast as JR
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.data import synthetic as JS
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.data import raycast as TR
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC
from vil_sensor_fusion_tpu_torch.data import synthetic as TS

DT = jnp.float64


def _pose(x, y, yaw):
    q = JL.so3_exp_quat(jnp.array([0.0, 0.0, yaw], DT))
    return JL.pose_make(q, jnp.array([x, y, 1.5], DT))


@pytest.mark.parametrize("pose", [(0.0, 0.0, 0.0), (7.3, 1.1, 0.4)])
def test_raycast_matches_jax(pose):
    world = JR.town_world(n_boxes=28, seed=0, dtype=DT)
    p = _pose(*pose)
    sj = JR.raycast(world, p)
    st = TR.raycast(convert.to_torch(world, "cpu"), torch.tensor(
        np.asarray(p)))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.rng.numpy(), np.asarray(sj.rng),
                               rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(st.xyz.numpy(), np.asarray(sj.xyz),
                               rtol=1e-10, atol=1e-9)


def test_sweep_series_matches_jax():
    world = JR.town_world(n_boxes=12, seed=3, dtype=DT)
    poses = jnp.stack([_pose(0.4 * i, 0.1 * i, 0.03 * i) for i in range(3)])
    sj = JR.sweep_series(world, poses)
    st = TR.sweep_series(convert.to_torch(world, "cpu"),
                         torch.from_numpy(np.asarray(poses)))
    assert tuple(st.xyz.shape) == (3, 16, 1800, 3)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.xyz.numpy(), np.asarray(sj.xyz),
                               rtol=1e-10, atol=1e-9)


def test_town_world_is_seeded_and_clears_the_street():
    """Drawn from numpy (JAX's PRNG cannot be reproduced), so only the
    structure matches the JAX world: one ground plane, n boxes, none of
    them straddling the street |y| < 8 m at its centre line."""
    a, b = (TR.town_world(n_boxes=28, seed=5, dtype=torch.float64,
                          device="cpu") for _ in range(2))
    j = JR.town_world(n_boxes=28, seed=5, dtype=DT)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert tuple(getattr(a, f).shape) == np.asarray(getattr(j, f)).shape
    cy = 0.5 * (a.box_min[:, 1] + a.box_max[:, 1])
    assert bool((cy.abs() >= 8.0).all())


def test_sample_imu_and_odometry_match_jax():
    """The town trajectory's IMU stream (forward-mode derivatives of the
    analytic path) and noise-free odometry stream."""
    t = np.arange(150) / 200.0
    tj = JSC._town_traj()
    tt = TSC._town_traj()
    ij = JS.sample_imu(tj, jnp.asarray(t, DT))
    it = TS.sample_imu(tt, torch.from_numpy(t))
    np.testing.assert_allclose(it.accel.numpy(), np.asarray(ij.accel),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(it.gyro.numpy(), np.asarray(ij.gyro),
                               rtol=1e-9, atol=1e-9)
    oj = JS.sample_odometry(tj, jnp.asarray(t[::10], DT))
    ot = TS.sample_odometry(tt, torch.from_numpy(t[::10]))
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses),
                               atol=1e-12)
    np.testing.assert_allclose(ot.cov.numpy(), np.asarray(oj.cov))
    vj = jax.vmap(tj.vel_fn)(jnp.asarray(t[:5], DT))
    vt = torch.stack([tt.vel_fn(torch.tensor(x, dtype=torch.float64))
                      for x in t[:5]])
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-12)


def test_odometry_noise_comes_from_the_generator():
    """Noise only with a ``torch.Generator``; the same seed gives the same
    stream, and the noise has the requested scale."""
    tt = TSC._town_traj()
    t = torch.arange(400, dtype=torch.float64) / 20.0
    clean = TS.sample_odometry(tt, t)
    a = TS.sample_odometry(tt, t, 0.05, 0.01,
                           generator=torch.Generator().manual_seed(3))
    b = TS.sample_odometry(tt, t, 0.05, 0.01,
                           generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.poses, b.poses)
    d = (a.poses[:, 4:] - clean.poses[:, 4:]).std().item()
    assert 0.04 < d < 0.06


def _worlds():
    """Every kind's JAX world at a test size (the random ones drawn by
    JAX, then handed over)."""
    return {
        "corridor": JR.corridor_world(dtype=DT),
        "arena": JR.arena_world(dtype=DT),
        "road": JR.road_world(length=60.0, seed=1, dtype=DT),
        "field": JR.field_world(10.0, 30.0, 40.0, seed=1, dtype=DT),
        "tunnel": JR.tunnel_world(x0=6.0, x1=30.0, dtype=DT),
        "tunnel_road": JR.tunnel_world(x0=6.0, x1=30.0, road_length=40.0,
                                       dtype=DT),
    }


@pytest.mark.parametrize("kind", ["corridor", "arena", "road", "field",
                                  "tunnel", "tunnel_road"])
def test_worlds_raycast_like_jax(kind):
    """A world handed over gives the same sweep, static and motion-distorted
    (one batched cast with an origin per azimuth column), to 1e-9; the hit
    masks are equal. (The random worlds come from numpy's RNG in the port,
    so only a handed-over world can equal JAX's.)"""
    world = _worlds()[kind]
    tw = convert.to_torch(world, "cpu")
    p0, p1 = _pose(8.0, 0.3, 0.1), _pose(8.4, 0.35, 0.16)
    sj = JR.raycast_motion(world, p0, p1)
    st = TR.raycast_motion(tw, *(torch.from_numpy(np.asarray(p))
                                 for p in (p0, p1)))
    rj = JR.raycast(world, p1)
    rt = TR.raycast(tw, torch.from_numpy(np.asarray(p1)))
    for a, b in ((st, sj), (rt, rj)):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a.rng.numpy(), np.asarray(b.rng),
                                   rtol=1e-9, atol=1e-9)
    assert float(st.mask.mean()) > 0.3
    # The distortion is there: the moving sweep is not the static one.
    assert np.abs(st.xyz.numpy() - rt.xyz.numpy()).max() > 0.05


def test_worlds_match_jax_in_structure():
    """The corridor and the arena come from no RNG and equal JAX's; the
    random worlds have JAX's shapes and sink the same kind of boxes (below
    z = -50) to keep them."""
    kw = dict(dtype=torch.float64, device="cpu")
    for j, t in ((JR.corridor_world(dtype=DT), TR.corridor_world(**kw)),
                 (JR.arena_world(dtype=DT), TR.arena_world(**kw))):
        for f in j._fields:
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)),
                                       rtol=0, atol=1e-15)
    for j, t, cleared, n_walls in (
            (JR.road_world(60.0, dtype=DT), TR.road_world(60.0, **kw), None,
             0),
            (JR.field_world(10.0, 30.0, 40.0, dtype=DT),
             TR.field_world(10.0, 30.0, 40.0, **kw), (10.0, 30.0), 0),
            (JR.tunnel_world(dtype=DT), TR.tunnel_world(**kw),
             (20.0 - 4.0, 44.0 + 4.0), 3)):
        for f in j._fields:
            assert tuple(getattr(t, f).shape) == np.asarray(
                getattr(j, f)).shape
        if cleared is None:
            continue
        # The boxes in the cleared x-range are sunk, the others stand (the
        # tunnel's walls come last).
        n = t.box_min.shape[0] - n_walls
        bmin, bmax = t.box_min.numpy()[:n], t.box_max.numpy()[:n]
        inside = (bmax[:, 0] > cleared[0]) & (bmin[:, 0] < cleared[1])
        sunk = bmin[:, 2] < -50.0
        np.testing.assert_array_equal(sunk, inside)
        assert sunk.any() and (~sunk).any()

"""The port's LiDAR ablation
(``vil_sensor_fusion_tpu_torch/lidar_ablation.py``) against the JAX package's ``scripts/lidar_ablation.py``:

- the six candidate schedules, field for field against JAX's
  ``LidarOdomConfig`` built here as the script builds them;
- the registration priors against JAX's double-``vmap``ped ``pose_between``
  plus the same ``default_rng(0)`` draws, within 1e-6 m (both in float32);
- the r4 default schedule (``eig_sweeps`` 4, which the bench never runs)
  over 2 lanes × 3 sweeps of the script's distorted town drives through
  ``odometry.run_lanes`` against ``jax.vmap(odometry.run)`` on the same
  numbers, in float32 at the band ``test_torch_lanes.py`` holds f32 lanes
  to: poses 1e-2 m, Hessians 5e-2 of their norm, ``n_corr`` 2% + 8;
- ``torch.func.vmap`` of ``jacobi_eigh`` at 3 and 4 sweeps, and the lane
  run, with ``vmap``'s batching-rule fallback warning as an error;
- ``main`` on the CPU (``--device cpu``): the JSON under the script's keys
  and one stderr line per candidate.

The drives are rendered by the port (the JAX package draws its town from
``jax.random``) and handed to JAX as numpy arrays; JAX runs in a child
process while the port computes."""

import json
import multiprocessing
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import lidar_ablation as TLA
from vil_sensor_fusion_tpu_torch.ops import eig6 as TE6

FALLBACK = ".*performance drop.*batching rule.*"
LANES, DURATION = 2, 0.3      # 3 sweeps per lane
CASE = "r4_default (m4 o6 f2 e4)"


def _jax_cfg_of(map_iters, odom_iters, fit_every, eig_sweeps,
                final_refresh=False):
    """``scripts/lidar_ablation.py``'s ``cfg_of``."""
    from vil_sensor_fusion_tpu.frontends import lidar as L

    return L.LidarOdomConfig(
        icp=L.IcpConfig(iters=map_iters, degen_eigval=5.0,
                        fit_every=fit_every, final_refresh=final_refresh,
                        eig_sweeps=eig_sweeps),
        odom_icp=L.IcpConfig(iters=odom_iters, max_corr_dist=2.0,
                             degen_eigval=5.0, fit_every=fit_every,
                             final_refresh=final_refresh,
                             eig_sweeps=eig_sweeps),
        two_stage=True, undistort=True, guess_is_delta=True)


JAX_CANDIDATES = {
    "r4_default (m4 o6 f2 e4)": (4, 6, 2, 4),
    "m3 o4 f2 e4": (3, 4, 2, 4),
    "m4 o6 f3 e4": (4, 6, 3, 4),
    "m3 o4 f3 e3": (3, 4, 3, 3),
    "m2 o4 f2 e3": (2, 4, 2, 3),
    "m3 o3 f3 e3": (3, 3, 3, 3),
}


def _jax_lanes(args, sweeps, prior, pose0):
    """``jax.vmap`` of JAX's ``odometry.run`` over the lanes, as the
    script maps it; the outputs as numpy."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from vil_sensor_fusion_tpu.frontends import lidar as L

    f32 = jnp.float32
    cfg = _jax_cfg_of(*args)
    st0 = jax.vmap(lambda p: L.odometry.init(cfg, f32, pose0=p))(
        jnp.asarray(pose0, f32))
    run = jax.jit(jax.vmap(lambda st, sw, gu: L.odometry.run(cfg, st, sw,
                                                             gu)))
    _, out = run(st0, L.Sweep(*(jnp.asarray(x, f32) for x in sweeps)),
                 jnp.asarray(prior, f32))
    return {k: np.asarray(getattr(out, k))
            for k in ("pose", "odom_pose", "hessian", "n_corr")}


@pytest.fixture(scope="module")
def drives():
    sweeps, gt = TLA.build_lanes(DURATION, LANES, "cpu")
    return sweeps, gt, TLA.guesses(gt, "cpu")


@pytest.fixture(scope="module")
def lanes(drives):
    """(JAX's outputs, the port's) for :data:`CASE`."""
    sweeps, gt, prior = drives
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        fut = pool.submit(_jax_lanes, JAX_CANDIDATES[CASE],
                          [x.numpy() for x in sweeps], prior.numpy(),
                          gt[:, 0])
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=FALLBACK)
            row, out = TLA.run_candidate(TLA.CANDIDATES[CASE], sweeps,
                                         prior, gt, reps=1)
        return fut.result(), out, row


def _fields(cfg):
    """A config as nested dicts of its fields."""
    return {k: _fields(v) if hasattr(v, "_asdict") else v
            for k, v in cfg._asdict().items()}


def test_candidates_match_the_scripts():
    assert list(TLA.CANDIDATES) == list(JAX_CANDIDATES)
    for name, args in JAX_CANDIDATES.items():
        assert _fields(TLA.CANDIDATES[name]) == _fields(_jax_cfg_of(*args)), \
            name


def test_guesses_match_jax(drives):
    import jax
    import jax.numpy as jnp
    from vil_sensor_fusion_tpu.core import lie as JL

    _, gt, prior = drives
    rng = np.random.default_rng(0)
    prev = np.concatenate([gt[:, :1], gt[:, :-1]], axis=1)
    g = np.array(jax.vmap(jax.vmap(JL.pose_between))(
        jnp.asarray(prev, jnp.float32), jnp.asarray(gt, jnp.float32)))
    g[..., 4:7] += rng.normal(0, 0.01, g[..., 4:7].shape)
    assert prior.dtype == torch.float32 and prior.shape == (LANES, 3, 7)
    np.testing.assert_allclose(prior.numpy(), g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sweeps", [3, 4])
def test_jacobi_eigh_maps_at_the_candidates_sweeps(sweeps):
    """The ablation's eigen-solver sweep counts batch under
    ``torch.func.vmap`` with no fallback, each lane as it is alone."""
    A = torch.randn(3, 6, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(sweeps))
    A = A @ A.transpose(-1, -2)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        w, V = torch.func.vmap(lambda a: TE6.jacobi_eigh(a, sweeps))(A)
    for b in range(3):
        w1, V1 = TE6.jacobi_eigh(A[b], sweeps)
        torch.testing.assert_close(w[b], w1, rtol=0, atol=1e-12)
        torch.testing.assert_close(V[b], V1, rtol=0, atol=1e-12)


def test_lane_run_matches_jax_vmap(lanes):
    want, got, row = lanes
    assert got.pose.shape == (LANES, 3, 7) and got.pose.dtype == torch.float32
    for k in ("pose", "odom_pose"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0,
                                   atol=1e-2, err_msg=k)
    Ht, Hj = got.hessian.numpy(), want["hessian"]
    err = np.linalg.norm(Ht - Hj, axis=(-2, -1))
    assert (err <= 5e-2 * np.linalg.norm(Hj, axis=(-2, -1)) + 1e-6).all()
    np.testing.assert_allclose(got.n_corr.numpy(), want["n_corr"],
                               rtol=2e-2, atol=8)
    assert row["knn_launches_per_sweep"] == 0      # no kernel on the CPU
    assert row["err_max_m"] < 0.5


def test_main_on_the_cpu(capsys):
    """Every candidate over one lane of one sweep."""
    out = TLA.main(["--device", "cpu", "--duration", "0.1", "--batch", "1",
                    "--reps", "1"])
    cap = capsys.readouterr()
    assert json.loads(cap.out) == out
    assert list(out) == list(JAX_CANDIDATES)
    for name, row in out.items():
        assert set(row) == {"lidar_stage_ms", "err_mean_m", "err_max_m",
                            "first_call_s", "knn_launches_per_sweep"}
        assert np.isfinite(row["lidar_stage_ms"]) and row["err_max_m"] < 0.5
    lines = cap.err.strip().splitlines()
    assert lines[0] == "platform=cpu"
    assert [ln[:28].rstrip() for ln in lines[1:]] == list(JAX_CANDIDATES)


def test_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TLA.main(["--duration", "0.2", "--batch", "2"])

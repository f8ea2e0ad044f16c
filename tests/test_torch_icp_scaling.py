"""The port's ICP scaling curve
(``vil_sensor_fusion_tpu_torch/icp_scaling_curve.py``) on the CPU: worlds of
1 and 2 gloo processes (``--device cpu --sizes 1,2``) run the sharded LiDAR
step of ``parallel.make_sharded_lidar_step``, and rank 0's ``n_corr`` is the
same at both sizes and equal to JAX's ``make_sharded_lidar_step`` on the
conftest's virtual CPU devices (n = 1 and 2) over the same inputs.

The JAX package draws its town world from ``jax.random`` and the port from
numpy, so JAX is handed the port's two sweeps as numpy arrays (the
curve's config and pose guesses are the script's). ``n_corr`` counts
correspondences. Across the port's sizes it is held exactly. Against JAX
the step runs in float32, as the script does, and an f32 chain of two
registrations flips a line or plane gate sooner or later, so it is held to
the band ``test_torch_lidar.py`` holds f32 odometry to: 2% + 8 (measured:
766 against 764). The JAX side runs in two child processes (one per size)
while the port's ranks run."""

import contextlib
import io
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import icp_scaling_curve as TIC

SIZES = (1, 2)
N_CORR_RTOL, N_CORR_ATOL = 2e-2, 8     # the f32 band of test_torch_lidar.py


def _jax_n_corr(n, sweeps, guesses):
    """JAX's sharded step over ``n`` virtual devices: the first sweep, then
    the second from the state after it; ``n_corr`` of the second."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from vil_sensor_fusion_tpu import parallel as par
    from vil_sensor_fusion_tpu.frontends import lidar as L

    f32 = jnp.float32
    cfg = L.LidarOdomConfig(icp=L.IcpConfig(iters=6, degen_eigval=5.0))
    mesh = par.make_mesh(n_data=1, n_model=n, devices=jax.devices()[:n])
    step = par.make_sharded_lidar_step(mesh, cfg)
    (s0, s1), (p0, p1) = ([L.Sweep(*(jnp.asarray(x, f32) for x in s))
                           for s in sweeps],
                          [jnp.asarray(p, f32) for p in guesses])
    st, _ = step(L.odometry.init(cfg, f32), s0, p0)
    _, res = step(st, s1, p1)
    return float(res.n_corr)


@pytest.fixture(scope="module")
def curve():
    """(JAX's n_corr per size, the port's curve, its stdout)."""
    _, (s0, p0), (s1, p1) = TIC.problem("cpu")
    sweeps = [[x.numpy() for x in s] for s in (s0, s1)]
    guesses = [p0.numpy(), p1.numpy()]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(SIZES), mp_context=ctx) as pool:
        futs = {n: pool.submit(_jax_n_corr, n, sweeps, guesses)
                for n in SIZES}
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            port = TIC.main(["--device", "cpu", "--sizes", "1,2"], reps=1)
        return {n: f.result() for n, f in futs.items()}, port, printed


def test_the_curve_prints_the_jax_keys(curve):
    _, port, printed = curve
    assert json.loads(printed.getvalue()) == port     # one JSON object
    assert set(port) == {"1", "2"}
    for row in port.values():
        assert set(row) == {"step_ms", "n_corr", "knn_launches"}
        assert np.isfinite(row["step_ms"]) and row["step_ms"] > 0
        assert row["knn_launches"] == 0       # the CPU launches no kernel


def test_n_corr_is_the_same_at_every_size(curve):
    """The ICP's sums split over two processes pick the same
    correspondences."""
    _, port, _ = curve
    assert port["1"]["n_corr"] == port["2"]["n_corr"] > 300


@pytest.mark.parametrize("n", SIZES)
def test_n_corr_matches_jax(curve, n):
    jax_n_corr, port, _ = curve
    np.testing.assert_allclose(port[str(n)]["n_corr"], jax_n_corr[n],
                               rtol=N_CORR_RTOL, atol=N_CORR_ATOL)


def test_sizes_beyond_the_cards_raise_before_any_run():
    """A size needing more cards than are visible raises, naming the ways
    out (``--sizes 1`` on one card, ``--device cpu``)."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="--sizes 1 on one card, or "
                                           "--device cpu"):
        TIC.check_sizes([1, have + 1], "cuda")
    TIC.check_sizes([1, 2, 4, 8], "cpu")


def test_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TIC.main(["--sizes", "1"])

"""The port's window-sharded pose-chain smoother (``parallel.windows``)
against the JAX package's: ``solve_sharded`` on 4 gloo ranks
(``torch.multiprocessing.spawn``, a ``file://`` store under ``tmp_path``),
N = 32, the chain problem of ``tests/test_windows_sharding.py``, against
JAX's ``solve_sequential`` and its ``solve_sharded`` on a 4-device mesh.
In float32 with that file's tolerance (positions 2e-3, quaternion dots
1 − 1e-5); in float64 to summation order (1e-9). The same 4 ranks also
solve with 2 windows (ranks 2 and 3 outside the grid), which must give
the same chain."""

import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from vil_sensor_fusion_tpu.parallel import mesh as JPM
from vil_sensor_fusion_tpu.parallel import windows as JWIN
from vil_sensor_fusion_tpu_torch.core import lie as TL
from vil_sensor_fusion_tpu_torch.parallel import mesh as TPM
from vil_sensor_fusion_tpu_torch.parallel import windows as TWIN

RANKS = 4
N = 32
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}


def _rank_entry(rank, world, init, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks (a ``file://``
    store under ``tmp_path``, no port)."""
    init = f"file://{tmp_path / f'store-{fn.__name__}'}"
    torch.multiprocessing.spawn(_rank_entry, args=(world, init, fn, args),
                                nprocs=world, join=True)


def _ground_truth():
    ts = np.arange(N) * 0.1
    q = TL.so3_exp_quat(torch.as_tensor(
        np.stack([0.02 * ts, 0.01 * np.sin(ts), 0.3 * ts], -1)))
    p = torch.as_tensor(np.stack([2.0 * ts, np.sin(0.5 * ts), 0.1 * ts], -1))
    return torch.cat([q, p], -1).numpy()


def _chain_problem(seed=0):
    """tests/test_windows_sharding.py's chain: a smooth ground-truth
    trajectory, noisy odometry between its states, noisy initial
    estimates (float64 numpy)."""
    rng = np.random.default_rng(seed)
    gt = torch.as_tensor(_ground_truth())
    meas = TL.pose_between(gt[:-1], gt[1:])
    meas = TL.pose_retract(meas, torch.as_tensor(
        rng.normal(0, 0.01, (N - 1, 6))))
    infos = np.broadcast_to(np.eye(6) * 100.0, (N - 1, 6, 6)).copy()
    x0 = TL.pose_retract(gt, torch.as_tensor(rng.normal(0, 0.05, (N, 6))))
    return (x0.numpy(), meas.numpy(), infos, gt[0].numpy(),
            np.eye(6) * 1e4)


def _windows_worker(rank, problems, out_path):
    mesh4 = TPM.make_mesh(n_data=RANKS, n_model=1, devices="cpu")
    mesh2 = TPM.make_mesh(n_data=2, n_model=1, devices="cpu")
    out = {}
    for name, (tdt, _) in DTYPES.items():
        args = [torch.as_tensor(a, dtype=tdt) for a in problems]
        out[name, 4] = TWIN.solve_sharded(mesh4, TPM.DATA_AXIS, *args,
                                          iters=5).numpy()
        if mesh2.coords is not None:
            out[name, 2] = TWIN.solve_sharded(mesh2, TPM.DATA_AXIS, *args,
                                              iters=5).numpy()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def problem():
    return _chain_problem()


@pytest.fixture(scope="module")
def sharded(problem, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("windows")
    spawn(_windows_worker, RANKS, tmp, problem, tmp / "out.pkl")
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def _assert_chain_close(a, b, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(a[:, 4:7], b[:, 4:7], atol=2e-3)
        dots = np.abs(np.sum(a[:, :4] * b[:, :4], axis=-1))
        assert dots.min() > 1.0 - 1e-5, dots.min()
    else:
        np.testing.assert_allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sharded_on_four_ranks_matches_jax(problem, sharded, dtype):
    tdt, jdt = DTYPES[dtype]
    jargs = [jnp.asarray(a, jdt) for a in problem]
    seq_j = np.asarray(JWIN.solve_sequential(*jargs, iters=5))
    mesh = JPM.make_mesh(n_data=RANKS, n_model=1)
    shd_j = np.asarray(JWIN.solve_sharded(mesh, JPM.DATA_AXIS, *jargs,
                                          iters=5))
    shd_t = sharded[dtype, 4]
    assert shd_t.shape == (N, 7) and shd_t.dtype == np.dtype(dtype)
    _assert_chain_close(shd_t, seq_j, dtype)
    _assert_chain_close(shd_t, shd_j, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sequential_matches_jax(problem, dtype):
    tdt, jdt = DTYPES[dtype]
    seq_t = TWIN.solve_sequential(
        *[torch.as_tensor(a, dtype=tdt) for a in problem], iters=5).numpy()
    seq_j = np.asarray(JWIN.solve_sequential(
        *[jnp.asarray(a, jdt) for a in problem], iters=5))
    _assert_chain_close(seq_t, seq_j, dtype)


def test_window_count_independence(problem, sharded):
    """2 and 4 windows give the same chain: the sharding is an exact
    reformulation of the dense solve, not an approximation."""
    for dtype in DTYPES:
        _assert_chain_close(sharded[dtype, 2], sharded[dtype, 4], dtype)

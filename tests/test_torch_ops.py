"""Parity of the port's ops with the JAX package on identical numpy inputs:
the exact k-NN (plain PyTorch version of the CUDA kernel) against the
Pallas kernel in interpret mode and against ``knn_topk``, and the
closed-form / Jacobi eigen-solvers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.ops import eig3 as J3
from vil_sensor_fusion_tpu.ops import eig6 as J6
from vil_sensor_fusion_tpu.ops import knn as JK
from vil_sensor_fusion_tpu_torch.ops import eig3 as T3
from vil_sensor_fusion_tpu_torch.ops import eig6 as T6
from vil_sensor_fusion_tpu_torch.ops import knn as TK


def _knn_case(name):
    """(queries, targets, mask) float32, from a fixed numpy seed."""
    rng = np.random.default_rng(0)
    if name == "dense":                      # the test_knn_ops.py problem
        q = rng.standard_normal((50, 3)) * 5
        t = rng.standard_normal((700, 3)) * 5
        m = (rng.uniform(size=700) > 0.1)
    elif name == "map_coords_masked":        # ~100 m offsets, 30% masked
        q = rng.uniform(-20, 20, (77, 3)) + 100.0
        t = rng.uniform(-20, 20, (1001, 3)) + 100.0
        m = rng.uniform(size=1001) > 0.3
    elif name == "duplicates":               # exact duplicate targets
        base = rng.standard_normal((40, 3)) * 3
        t = np.concatenate([base, base[::-1], base[:7]])
        q = base[:13] + 0.01 * rng.standard_normal((13, 3))
        m = np.ones(len(t), bool)
    elif name == "few_valid":                # fewer than k valid targets
        q = rng.standard_normal((9, 3))
        t = rng.standard_normal((16, 3))
        m = np.zeros(16, bool)
        m[[2, 9, 11]] = True
    elif name == "single_query":
        q = rng.standard_normal((1, 3))
        t = rng.standard_normal((37, 3))
        m = np.ones(37, bool)
    else:
        raise ValueError(name)
    return (q.astype(np.float32), t.astype(np.float32),
            m.astype(np.float32))


KNN_CASES = ["dense", "map_coords_masked", "duplicates", "few_valid",
             "single_query"]


def _assert_knn_match(idx, d2, idx_ref, d2_ref, tol):
    """Distances agree within ``tol`` (inf where the reference is inf);
    indices agree wherever the reference distance is finite and separated
    from its neighbours in the row by more than ``tol`` (exact ties are not
    separated, but both sides order them lowest index first — checked by
    the duplicates case through its bit-identical distances)."""
    fin = np.isfinite(d2_ref)
    np.testing.assert_array_equal(np.isfinite(d2), fin)
    np.testing.assert_allclose(d2[fin], d2_ref[fin], rtol=1e-5, atol=tol)
    with np.errstate(invalid="ignore"):          # inf - inf rows
        gap_prev = np.diff(d2_ref, axis=1, prepend=-np.inf)
        gap_next = np.diff(d2_ref, axis=1, append=np.inf)
    sep = fin & (gap_prev > tol) & (gap_next > tol)
    np.testing.assert_array_equal(idx[sep], idx_ref[sep])


@pytest.mark.parametrize("case", KNN_CASES)
@pytest.mark.parametrize("reference", ["pallas_interpret", "topk"])
def test_knn_torch_matches_jax(case, reference):
    q, t, m = _knn_case(case)
    if reference == "pallas_interpret":
        ij, dj = JK.knn_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m),
                               k=5, query_block=32, interpret=True,
                               select_bf16=False)
    else:
        ij, dj = JK.knn_topk(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m),
                             k=5)
    it, dt = TK.knn_torch(torch.from_numpy(q), torch.from_numpy(t),
                          torch.from_numpy(m))
    assert it.dtype == torch.int32 and tuple(it.shape) == (len(q), 5)
    # f32 expanded-form distances: ‖q‖², ‖t‖² up to ~1.5e4 m² at the map
    # offsets, so reassociation between the two matmuls moves a distance
    # by a few ulps of that magnitude (ulp ≈ 1e-3 m²).
    tol = 1e-2 if case == "map_coords_masked" else 1e-4
    _assert_knn_match(it.numpy(), dt.numpy(), np.asarray(ij), np.asarray(dj),
                      tol)


@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_torch_contract(case):
    """Ascending, in-range indices, masked targets never returned at a
    finite distance, lowest index first among exact duplicates."""
    q, t, m = _knn_case(case)
    idx, d2 = TK.knn_torch(torch.from_numpy(q), torch.from_numpy(t),
                           torch.from_numpy(m))
    idx, d2 = idx.numpy(), d2.numpy()
    assert ((idx >= 0) & (idx < len(t))).all()
    assert (d2[:, 1:] >= d2[:, :-1]).all()
    fin = np.isfinite(d2)
    assert (m[idx[fin]] > 0).all()
    assert fin.sum(axis=1).min() == min(5, int((m > 0).sum()))
    if case == "duplicates":
        for row_i, row_d in zip(idx, d2):
            for a in range(4):
                if row_d[a] == row_d[a + 1]:
                    assert row_i[a] < row_i[a + 1]


def test_knn_dispatch_cpu_and_refusals():
    q, t, m = _knn_case("dense")
    qt, tt, mt = map(torch.from_numpy, (q, t, m))
    i1, d1 = TK.knn(qt, tt, mt)
    i2, d2 = TK.knn_torch(qt, tt, mt)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    # The CUDA wrapper checks its inputs before building or launching.
    with pytest.raises(ValueError):
        TK.knn_cuda(qt, tt, mt)                       # CPU tensors
    with pytest.raises(ValueError):
        TK.knn_cuda(qt, tt, mt, k=4)


def _sym3_cases():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((64, 3, 3))
    A = A @ np.swapaxes(A, -1, -2)
    # Degenerate corners: rank-1 (line-like), isotropic, zero.
    v = rng.standard_normal((8, 3))
    rank1 = v[:, :, None] * v[:, None, :]
    iso = np.eye(3)[None] * rng.uniform(0.5, 2.0, (4, 1, 1))
    zero = np.zeros((2, 3, 3))
    return np.concatenate([A, rank1, iso, zero])


def test_eigh3_matches_jax():
    A = _sym3_cases()
    wj, Vj = J3.eigh3(jnp.asarray(A))
    wt, Vt = T3.eigh3(torch.from_numpy(A))
    # f64 on both sides, same closed form: eigenvalues agree to f64
    # round-off, and so do the eigenvectors, incl. the fixed fallbacks of
    # the isotropic and zero matrices (rows 72-77).
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9,
                               atol=1e-9)
    Vt, Vj = Vt.numpy(), np.asarray(Vj)
    distinct = np.r_[0:64, 72:78]
    np.testing.assert_allclose(Vt[distinct], Vj[distinct], rtol=1e-6,
                               atol=1e-6)
    # Rank-1 rows 64-71 have a double zero eigenvalue: any basis of that
    # plane is right and round-off picks one, so only the principal
    # (line-direction) vector is determined.
    np.testing.assert_allclose(Vt[64:72, :, 2], Vj[64:72, :, 2], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sweeps", [3, 6])
def test_jacobi_eigh_and_eig_solve_match_jax(sweeps):
    rng = np.random.default_rng(5)
    J = rng.standard_normal((10, 40, 6))
    H = np.einsum("bqi,bqj->bij", J, J) + np.eye(6) * 1e-3
    wj, Vj = J6.jacobi_eigh(jnp.asarray(H), sweeps=sweeps)
    wt, Vt = T6.jacobi_eigh(torch.from_numpy(H), sweeps=sweeps)
    # Same rotation sequence in f64: round-off-level agreement.
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), rtol=1e-7,
                               atol=1e-7)
    g = rng.standard_normal((10, 6))
    keep = (np.asarray(wj) > 5.0).astype(np.float64)
    xj = J6.eig_solve(wj, Vj, jnp.asarray(g), damping=1e-3,
                      keep=jnp.asarray(keep))
    xt = T6.eig_solve(wt, Vt, torch.from_numpy(g), damping=1e-3,
                      keep=torch.from_numpy(keep))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-7,
                               atol=1e-9)

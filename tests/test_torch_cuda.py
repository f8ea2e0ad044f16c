"""The hand-written CUDA k-NN kernel against its plain PyTorch version, on
the card. Marked ``cuda``: each test skips where no CUDA device is present
(the CPU run of the suite), because a CUDA kernel has no CPU build. On a
machine with an NVIDIA card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: both sides evaluate ‖q‖² − 2q·t + ‖t‖² in f32 and sum in
another order, so a distance moves by a few ulps of its largest term:
4 ulps of max ‖q‖² + max ‖t‖² (about 0.05 m² at 100 m offsets). Indices
must agree wherever the neighbours are further apart than that.

Also here: the degeneracy scores on the card (CUDA's LU, eigen and
singular-value routines) against the CPU's, in float64, with the NaN and
±inf pattern of a series that starts with the zero Hessian."""

import pytest
import torch

from vil_sensor_fusion_tpu_torch.ops import knn as K

pytestmark = pytest.mark.cuda

# Q one past a query tile and M one past a split boundary (M − 1 targets
# fill the plan's splits exactly): (193, 1937) and (385, 4001), checked on
# the CPU by tests/test_torch_knn_plan.py.
ONE_PAST = [(193, 1937), (385, 4001)]
SHAPES = [(192, 1920), (384, 3984), (1920, 2048), (3984, 4096), (77, 4097),
          (1, 6), (3984, 49152), (64, 1), (1, 4096), *ONE_PAST,
          (1920, 4096), (3984, 8192)]     # the experiment harness's submaps
# Queries on targets at 100 m (distances cancel to a few ulps either side
# of 0), and on targets copied 2,048 places on into another split.
SEL = [0, 3, 64, 500, 1023, 1024, 1500, 2047]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(Q, M, dev, seed=0, kind="random"):
    g = torch.Generator().manual_seed(seed)
    q = torch.rand(Q, 3, generator=g) * 40 + 100
    t = torch.rand(M, 3, generator=g) * 40 + 100
    m = (torch.rand(M, generator=g) > 0.3).float()
    if kind in ("on_target", "split_tie"):
        m = torch.ones(M)
        if kind == "split_tie":
            t[2048 + torch.tensor(SEL)] = t[SEL]
        q = t[SEL]
    return q.to(dev), t.to(dev), m.to(dev)


@pytest.mark.parametrize("case", [("random", s) for s in SHAPES]
                         + [("on_target", (8, 2048)),
                            ("split_tie", (8, 4096))])
def test_knn_cuda_matches_plain(dev, case):
    kind, shape = case
    q, t, m = _problem(*shape, dev, kind=kind)
    i_k, d_k = K.knn_cuda(q, t, m)
    torch.cuda.synchronize()
    i_p, d_p = K.knn_torch(q, t, m, k=6)
    tol = 4 * torch.finfo(torch.float32).eps * float(
        (q * q).sum(1).max() + (t * t).sum(1).max())
    fin = torch.isfinite(d_p[:, :5])
    assert torch.equal(torch.isfinite(d_k), fin)
    assert not fin.any() or float(
        (d_k - d_p[:, :5])[fin].abs().max()) <= tol
    assert bool(((i_k >= 0) & (i_k < shape[1])).all())
    gaps = torch.diff(d_p, dim=1)
    prev = torch.cat([torch.full_like(gaps[:, :1], torch.inf),
                      gaps[:, :4]], 1)
    sep = fin & (prev > tol) & (gaps > tol)
    assert torch.equal(i_k[sep], i_p[:, :5][sep])
    tie = (d_k[:, 1:] == d_k[:, :-1]) & fin[:, 1:]
    assert bool((i_k[:, 1:] > i_k[:, :-1])[tie].all())
    if kind == "on_target":
        assert i_k[:, 0].tolist() == SEL
    if kind == "split_tie":
        assert K._plan(*shape).split_len <= 2048
        assert i_k[:, :2].tolist() == [[i, i + 2048] for i in SEL]


def test_knn_ties_and_sparse_rows(dev):
    """All targets equal: the lowest valid indices, in order. Three valid
    targets: two +inf slots, every index still in range."""
    t = torch.full((64, 3), 101.5, device=dev)
    m = torch.ones(64, device=dev)
    m[[0, 2]] = 0.0
    idx, _ = K.knn_cuda(torch.rand(5, 3, device=dev) + 100, t, m)
    assert idx.tolist() == [[1, 3, 4, 5, 6]] * 5
    q, t, _ = _problem(9, 16, dev)
    m = torch.zeros(16, device=dev)
    m[[2, 9, 11]] = 1.0
    idx, d2 = K.knn_cuda(q, t, m)
    assert bool(torch.isinf(d2[:, 3:]).all()) and bool(
        torch.isfinite(d2[:, :3]).all())
    assert bool(((idx >= 0) & (idx < 16)).all())


def test_knn_routes_cuda_tensors_to_the_kernel(dev):
    q, t, m = _problem(50, 700, dev)
    before = K.KERNEL_LAUNCHES
    K.knn(q, t, m)
    assert K.KERNEL_LAUNCHES == before + 1
    with pytest.raises(TypeError):
        K.knn(q.double(), t.double(), m.double())


def test_score_series_on_the_card_matches_the_cpu(dev):
    from vil_sensor_fusion_tpu_torch.degeneracy import gate, metrics

    g = torch.Generator().manual_seed(5)
    A = torch.randn(9, 6, 6, generator=g, dtype=torch.float64)
    mats = A @ A.transpose(-1, -2) + 0.5 * torch.eye(6, dtype=torch.float64)
    mats[0] = 0.0                              # the map-seeding first sweep
    mats[4] = 0.0
    mats[4][[0, 0, 3, 3], [0, 3, 0, 3]] = torch.tensor(
        [4.0, 1.0, 1.0, 3.0], dtype=torch.float64)          # rank 2
    names = sorted(metrics.METRICS)
    cpu = gate.score_series(names, mats)
    card = gate.score_series(names, mats.to(dev))
    for name in names:
        for a, b in zip(card[name], cpu[name]):
            a = a.cpu()
            for cls in (torch.isnan, torch.isposinf, torch.isneginf):
                assert torch.equal(cls(a), cls(b)), name
            fin = torch.isfinite(b)
            torch.testing.assert_close(a[fin], b[fin], rtol=1e-9, atol=1e-9)

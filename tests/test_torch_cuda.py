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


# ---------------------------------------------------------------------------
# The lane entry: B searches of one shape in one launch
# ---------------------------------------------------------------------------

LANE_SHAPES = [(192, 1920), (384, 3984), (1920, 2048), (3984, 4096),
               *ONE_PAST, (1, 6)]


def _lanes(Q, M, dev, B=8, seed=0):
    """B lanes, each its own clouds and its own mask density."""
    g = torch.Generator().manual_seed(seed)
    q = torch.rand(B, Q, 3, generator=g) * 40 + 100
    t = torch.rand(B, M, 3, generator=g) * 40 + 100
    m = (torch.rand(B, M, generator=g)
         > torch.linspace(0.05, 0.75, B)[:, None]).float()
    return q.to(dev), t.to(dev), m.to(dev)


@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_knn_cuda_lanes_equals_each_lanes_single_search(dev, shape):
    """One launch for 8 lanes gives, lane for lane, the single-search
    kernel's bits (a result does not depend on the grid), and
    ``knn_torch_lanes`` within the tolerance above."""
    q, t, m = _lanes(*shape, dev)
    before = K.KERNEL_LAUNCHES
    i_k, d_k = K.knn_cuda_lanes(q, t, m)
    torch.cuda.synchronize()
    assert K.KERNEL_LAUNCHES == before + 1
    i_p, d_p = K.knn_torch_lanes(q, t, m)
    tol = 4 * torch.finfo(torch.float32).eps * float(
        (q * q).sum(-1).max() + (t * t).sum(-1).max())
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_k), fin)
    assert not fin.any() or float((d_k - d_p)[fin].abs().max()) <= tol
    for b in range(q.shape[0]):
        i_1, d_1 = K.knn_cuda(q[b], t[b], m[b])
        assert torch.equal(i_1, i_k[b]) and torch.equal(d_1, d_k[b])


def test_knn_lanes_one_valid_target_and_ties_across_splits(dev):
    q, t, m = _lanes(384, 3984, dev)
    m[5] = 0.0
    m[5, 1234] = 1.0
    idx, d2 = K.knn_cuda_lanes(q, t, m)
    assert idx[5, :, 0].eq(1234).all() and idx[5, :, 1:].eq(0).all()
    assert bool(torch.isinf(d2[5, :, 1:]).all())
    _, t, _ = _lanes(8, 4096, dev)
    sel = torch.stack([(torch.tensor(SEL) + b) % 2048 for b in range(8)])
    for b in range(8):
        t[b, 2048 + sel[b]] = t[b, sel[b]]
    q = torch.stack([t[b, sel[b]] for b in range(8)])
    idx, _ = K.knn_cuda_lanes(q, t, torch.ones(8, 4096, device=dev))
    assert torch.equal(idx[..., :2].cpu().long(),
                       torch.stack([sel, sel + 2048], -1))


def test_vmap_of_knn_is_one_lane_launch(dev):
    """``torch.func.vmap(ops.knn.knn)`` on CUDA tensors goes through the
    custom op's batching rule: one lane launch for all lanes, an unbatched
    target set expanded to every lane."""
    q, t, m = _lanes(384, 3984, dev, B=4)
    before = K.KERNEL_LAUNCHES
    idx, d2 = torch.func.vmap(K.knn)(q, t, m)
    i_l, d_l = K.knn_cuda_lanes(q, t, m)
    assert K.KERNEL_LAUNCHES == before + 2
    assert torch.equal(idx, i_l) and torch.equal(d2, d_l)
    idx, _ = torch.func.vmap(K.knn, in_dims=(0, None, None))(q, t[0], m[0])
    for b in range(4):
        assert torch.equal(idx[b], K.knn_cuda(q[b], t[0], m[0])[0])


def test_odometry_run_lanes_on_the_card(dev):
    """Two drives through ``odometry.run_lanes`` on the card: 4 k-NN
    launches per sweep for both lanes together, each lane equal to its
    single ``odometry.run`` on the card within the f32 band of
    tests/test_torch_lidar.py (1e-2 m; n_corr 2% + 8)."""
    from vil_sensor_fusion_tpu_torch import _tree
    from vil_sensor_fusion_tpu_torch.core import lie
    from vil_sensor_fusion_tpu_torch.data import raycast as R
    from vil_sensor_fusion_tpu_torch.frontends import lidar as L
    from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as vm

    cfg = L.LidarOdomConfig(
        icp=L.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                        final_refresh=False, eig_sweeps=3),
        odom_icp=L.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                             fit_every=4, final_refresh=False, eig_sweeps=3),
        corner_map=vm.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=vm.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024,
        two_stage=True, undistort=True, guess_is_delta=True)
    T, lanes = 3, []
    for seed, v in ((2, 0.4), (3, 0.35)):
        world = R.town_world(n_boxes=24, seed=seed, device=dev)
        poses = torch.stack([lie.pose_make(
            lie.so3_exp_quat(torch.tensor([0.0, 0.0, 0.02 * v * i],
                                          device=dev)),
            torch.tensor([v * i, 0.05 * v * i, 1.5], device=dev))
            for i in range(T)])
        prev = torch.cat([poses[:1], poses[:-1]])
        lanes.append((L.odometry.init(cfg, pose0=poses[0]),
                      R.sweep_series(world, poses),
                      lie.pose_between(prev, poses)))
    st, sw, g = (_tree.tree_map(lambda *x: torch.stack(x), *f)
                 for f in zip(*lanes))
    before = K.KERNEL_LAUNCHES
    _, out = L.odometry.run_lanes(cfg, st, sw, g)
    torch.cuda.synchronize()
    assert K.KERNEL_LAUNCHES - before == 4 * T
    for b, (s1, w1, g1) in enumerate(lanes):
        _, o1 = L.odometry.run(cfg, s1, w1, g1)
        assert float((out.pose[b] - o1.pose).abs().max()) < 1e-2
        assert torch.allclose(out.n_corr[b], o1.n_corr, rtol=2e-2, atol=8)

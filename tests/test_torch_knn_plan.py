"""The host-side plan of the CUDA k-NN kernel's grid (``ops/knn._plan``):
pure Python, so it is checked here on the CPU. Every target falls in
exactly one non-empty split whose start is 16-byte aligned, the query tiles
cover every query, and the main-path shapes get about two blocks (16
warps) per SM of an H100."""

import pytest

from vil_sensor_fusion_tpu_torch.ops import knn as K

MAIN_PATH_SHAPES = [(192, 1920), (384, 3984), (1920, 2048), (3984, 4096)]
RAGGED_SHAPES = [(1, 1), (1, 63), (1, 64), (1, 4096), (5, 64), (17, 65),
                 (33, 16), (65, 4097), (77, 4097), (193, 1921), (257, 2049),
                 (1000, 3000), (3985, 4097), (3984, 49152), (20000, 49152),
                 (64, 1)]


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES + RAGGED_SHAPES)
def test_every_target_in_exactly_one_nonempty_split(shape):
    Q, M = shape
    p = K._plan(Q, M)
    seen = [0] * M
    for s in range(p.n_splits):
        lo, hi = s * p.split_len, min(M, (s + 1) * p.split_len)
        assert hi > lo, f"split {s} of {p} is empty"
        assert lo % 4 == 0
        for j in range(lo, hi):
            seen[j] += 1
    assert seen == [1] * M


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES + RAGGED_SHAPES)
def test_query_tiles_cover_the_queries(shape):
    Q, M = shape
    p = K._plan(Q, M)
    assert p.rows in (1, 2) and p.query_tile == 8 * p.rows
    assert (p.query_tiles - 1) * p.query_tile < Q
    assert Q <= p.query_tiles * p.query_tile
    assert p.blocks == p.query_tiles * p.n_splits


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_main_path_shapes_fill_the_card(shape):
    p = K._plan(*shape)
    assert 0.9 * K.TARGET_BLOCKS <= p.blocks <= 1.1 * K.TARGET_BLOCKS, p
    assert p.split_len >= 64


# The one-past shapes of tests/test_torch_cuda.py.
ONE_PAST = [(193, 1937), (385, 4001)]


@pytest.mark.parametrize("shape", ONE_PAST)
def test_one_past_shapes_cross_a_tile_and_a_split(shape):
    Q, M = shape
    p, full = K._plan(Q, M), K._plan(Q, M - 1)
    assert (Q - 1) % p.query_tile == 0
    assert full.n_splits > 1 and M - 1 == full.n_splits * full.split_len


@pytest.mark.parametrize("bad", ["k", "dtype"])
def test_knn_cuda_refuses_before_launching(bad):
    import torch

    q, t, m = torch.zeros(4, 3), torch.zeros(8, 3), torch.ones(8)
    before = K.KERNEL_LAUNCHES
    if bad == "k":
        with pytest.raises(ValueError, match="k=5"):
            K.knn_cuda(q, t, m, k=4)
    else:
        with pytest.raises(TypeError, match="float32"):
            K.knn_cuda(q.double(), t.double(), m.double())
    assert K.KERNEL_LAUNCHES == before


def test_knn_cuda_refuses_cpu_tensors():
    import torch

    q, t, m = torch.zeros(4, 3), torch.zeros(8, 3), torch.ones(8)
    with pytest.raises(ValueError):
        K.knn_cuda(q, t, m)
    before = K.KERNEL_LAUNCHES
    K.knn(q, t, m)
    assert K.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES + [(1, 6), (77, 4097)])
@pytest.mark.parametrize("B", [2, 8])
def test_lane_plans_cover_every_lane_and_fill_the_card(shape, B):
    """B lanes of one shape in one grid: the same split and tile rules
    per lane, B × tiles × splits blocks, no more (lane, query tile) pairs
    than the ticket buffer holds, and the bench's 8 lanes at their four
    shapes at least as many blocks as one lane gets (~2 per SM)."""
    Q, M = shape
    p = K._plan(Q, M, B)
    assert p.lanes == B and p.blocks == B * p.query_tiles * p.n_splits
    assert (p.query_tiles - 1) * p.query_tile < Q <= (p.query_tiles
                                                      * p.query_tile)
    assert (p.n_splits - 1) * p.split_len < M <= p.n_splits * p.split_len
    assert p.split_len % 4 == 0
    assert B * p.query_tiles <= K.MAX_QUERY_TILES
    if B == 8 and shape in MAIN_PATH_SHAPES:
        assert p.blocks >= 0.7 * K.TARGET_BLOCKS, p


def test_one_lane_plans_are_the_single_plans():
    for Q, M in MAIN_PATH_SHAPES + RAGGED_SHAPES:
        assert K._plan(Q, M, 1) == K._plan(Q, M)

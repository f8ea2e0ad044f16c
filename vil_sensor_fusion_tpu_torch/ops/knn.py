"""Exact masked k-nearest-neighbour search for ICP correspondence.

Port of ``vil_sensor_fusion_tpu/ops/knn.py``. Both functions here return
``(idx (Q, k) int32, dist² (Q, k))``, ascending, with the lowest target
index first among equal distances and masked targets at +inf:

- :func:`knn_torch` — plain PyTorch: the distance rows
  ‖q‖² − 2q·t + ‖t‖² from one ``torch.matmul``, then k passes of
  lowest-index argmin and mask-out (the selection of the TPU kernel).
- :func:`knn_cuda` — the hand-written Hopper kernel ``csrc/knn.cu``,
  replacing the TPU kernel ``_knn_kernel`` (k = 5, float32 only). One
  launch per call over a grid of (target splits × query tiles) that
  :func:`_plan` picks on the host.

:func:`knn` routes by device: a CPU tensor goes to :func:`knn_torch`, a CUDA
tensor to :func:`knn_cuda`, which raises rather than falling back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

K_DEFAULT = 5

# Launches of the CUDA kernel by knn_cuda (one per call), for callers that
# check which path a run went through.
KERNEL_LAUNCHES = 0


def knn_torch(
    queries: torch.Tensor,     # (Q, 3)
    targets: torch.Tensor,     # (M, 3)
    t_mask: torch.Tensor,      # (M,)
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch k-NN. ``torch.argmin`` returns the first minimum, so
    each pass takes the lowest index among equal distances (bare
    ``torch.topk`` promises no order among ties)."""
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    t_sq = torch.where(t_mask > 0, torch.sum(targets * targets, dim=-1),
                       torch.inf)
    d = q_sq - 2.0 * (queries @ targets.T) + t_sq[None, :]
    rows = torch.arange(queries.shape[0], device=queries.device)
    idxs, dists = [], []
    for _ in range(k):
        am = torch.argmin(d, dim=1)
        idxs.append(am)
        dists.append(d[rows, am])
        d[rows, am] = torch.inf
    return (torch.stack(idxs, dim=1).to(torch.int32),
            torch.stack(dists, dim=1))


class Plan(NamedTuple):
    """The kernel's grid for one call: (n_splits, query_tiles) blocks."""

    rows: int           # queries per warp (R: 1 or 2)
    query_tile: int     # queries per block: 8 warps, 8 R
    query_tiles: int
    n_splits: int       # contiguous target splits, none empty
    split_len: int      # targets per split (the last may hold fewer)

    @property
    def blocks(self) -> int:
        return self.query_tiles * self.n_splits


_WARPS = 8                # warps per block (csrc/knn.cu: THREADS / 32)
TARGET_BLOCKS = 264       # about two blocks (16 warps) per SM of an H100
_MIN_SPLIT = 64           # shortest split: 2 targets per lane


@functools.lru_cache(maxsize=256)
def _plan(Q: int, M: int) -> Plan:
    """The grid for Q queries and M targets (Q, M ≥ 1): two queries per
    warp once one per warp would already give :data:`TARGET_BLOCKS` query
    tiles, else one; then the target splits that bring the grid nearest to
    :data:`TARGET_BLOCKS` blocks, no split shorter than 64 targets, each a
    multiple of 4 long (16-byte aligned starts)."""
    rows = 2 if -(-Q // _WARPS) >= TARGET_BLOCKS else 1
    tiles = -(-Q // (_WARPS * rows))
    splits = max(1, min((TARGET_BLOCKS + tiles // 2) // tiles,
                        M // _MIN_SPLIT))
    split_len = -(-M // (4 * splits)) * 4
    return Plan(rows, _WARPS * rows, tiles, -(-M // split_len), split_len)


_KERNEL = None
# Query tiles sit in grid.y, which holds at most 65,535 of them (1,048,560
# queries at R = 2).
MAX_QUERY_TILES = 65535
# Per (device, stream): the kernel's per-query-tile tickets, one for every
# tile the grid can hold, zeroed once and never replaced (a captured CUDA
# graph keeps their address); each launch leaves them zeroed for the next
# on its stream.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _kernel():
    """The C entry point, built and bound at first use."""
    global _KERNEL
    if _KERNEL is None:
        fn = _build.load("knn").knn5_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    t = _TICKETS.get((dev.index, stream))
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("call knn_cuda once on this stream before "
                               "capturing it in a CUDA graph")
        t = torch.zeros(MAX_QUERY_TILES, dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def knn_cuda(
    queries: torch.Tensor,
    targets: torch.Tensor,
    t_mask: torch.Tensor,
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN by the CUDA kernel: one launch on the inputs' device's current
    stream. Inputs: contiguous float32 CUDA tensors on one device, queries
    (Q, 3), targets (M, 3) with M ≥ 1, t_mask (M,). The host work per call
    is kept small, since the main path calls this 4 times per sweep: the
    checks are three expressions, the plan is cached, the stream handle is
    read without building a Stream object, and the split scratch (only
    when the plan splits the targets) is the one allocation beside the
    outputs."""
    global KERNEL_LAUNCHES
    dev = queries.device
    f32 = torch.float32
    Q, M = queries.shape[0], targets.shape[0]
    if k != K_DEFAULT:
        raise ValueError(f"the CUDA kernel computes k={K_DEFAULT}, got {k}")
    if queries.dtype != f32 or targets.dtype != f32 or t_mask.dtype != f32:
        raise TypeError("knn_cuda takes float32 tensors, got "
                        f"{queries.dtype}, {targets.dtype}, {t_mask.dtype}")
    if (dev.type != "cuda" or targets.device != dev or t_mask.device != dev
            or queries.shape != (Q, 3) or targets.shape != (M, 3)
            or t_mask.shape != (M,) or M == 0
            or not (queries.is_contiguous() and targets.is_contiguous()
                    and t_mask.is_contiguous())):
        got = ", ".join(
            f"{tuple(x.shape)} on {x.device}"
            + ("" if x.is_contiguous() else " (not contiguous)")
            for x in (queries, targets, t_mask))
        raise ValueError("knn_cuda takes contiguous CUDA tensors on one "
                         "device: queries (Q, 3), targets (M, 3) with M >= 1, "
                         f"t_mask (M,); got {got}")
    idx = torch.empty(Q, K_DEFAULT, dtype=torch.int32, device=dev)
    dist = torch.empty(Q, K_DEFAULT, dtype=f32, device=dev)
    if Q == 0:
        return idx, dist
    p = _plan(Q, M)
    if p.query_tiles > MAX_QUERY_TILES:
        raise ValueError(f"knn_cuda takes at most {MAX_QUERY_TILES} query "
                         f"tiles of {p.query_tile}, got Q={Q}")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = tickets = None
    if p.n_splits > 1:
        scratch = torch.empty(Q * p.n_splits * K_DEFAULT, dtype=torch.int64,
                              device=dev)
        tickets = _tickets(dev, stream)
    err = _kernel()(
        queries.data_ptr(), targets.data_ptr(), t_mask.data_ptr(), Q, M,
        p.rows, p.n_splits, p.split_len, idx.data_ptr(), dist.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if tickets is None else tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn5_f32 launch failed: cudaError {err}")
    KERNEL_LAUNCHES += 1
    return idx, dist


def knn(
    queries: torch.Tensor,
    targets: torch.Tensor,
    t_mask: torch.Tensor,
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route by device: CPU → :func:`knn_torch`, CUDA → :func:`knn_cuda`."""
    if queries.device.type == "cpu":
        return knn_torch(queries, targets, t_mask, k)
    if queries.device.type == "cuda":
        return knn_cuda(queries, targets, t_mask, k)
    raise ValueError(f"no k-NN path for device {queries.device}")

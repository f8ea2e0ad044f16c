"""Exact masked k-nearest-neighbour search for ICP correspondence.

Port of ``vil_sensor_fusion_tpu/ops/knn.py``. Every search here returns
``(idx (Q, k) int32, dist² (Q, k))`` (with a leading lane axis B for the
lane entries), ascending, with the lowest target index first among equal
distances and masked targets at +inf:

- :func:`knn_torch` — plain PyTorch: the distance rows
  ‖q‖² − 2q·t + ‖t‖² from one ``torch.matmul``, then k passes of
  lowest-index argmin and mask-out (the selection of the TPU kernel).
- :func:`knn_cuda_lanes` — the hand-written Hopper kernel ``csrc/knn.cu``,
  replacing the TPU kernel ``_knn_kernel`` (k = 5, float32 only): B
  independent searches of one shape, (B, Q, 3) queries against (B, M, 3)
  targets, in one launch over a grid of (target splits × query tiles ×
  lanes) that :func:`_plan` picks on the host (the lane axis is what
  ``pallas_call`` gains under ``jax.vmap``). :func:`knn_cuda` is its
  one-lane view, :func:`knn_torch_lanes` its plain twin (``knn_torch`` per
  lane).

:func:`knn` routes by device: a CPU tensor goes to :func:`knn_torch` (which
``torch.func.vmap`` batches as it stands), a CUDA tensor to the custom op
``vil_sensor_fusion_tpu_torch::knn5`` on :func:`knn_cuda_lanes`, whose
batching rule folds ``torch.func.vmap``'s lanes into the kernel's, one
launch for all lanes. Neither falls back to the plain version: they
launch or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

K_DEFAULT = 5

# Launches of the CUDA kernel (one per call, whatever its lane count), for
# callers that check which path a run went through.
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


def knn_torch_lanes(
    queries: torch.Tensor,     # (B, Q, 3)
    targets: torch.Tensor,     # (B, M, 3)
    t_mask: torch.Tensor,      # (B, M)
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`knn_cuda_lanes`: :func:`knn_torch` per lane,
    results stacked (B, Q, k)."""
    outs = [knn_torch(q, t, m, k) for q, t, m in zip(queries, targets,
                                                     t_mask)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


class Plan(NamedTuple):
    """The kernel's grid for one call: (n_splits, query_tiles, lanes)
    blocks."""

    rows: int           # queries per warp (R: 1 or 2)
    query_tile: int     # queries per block: 8 warps, 8 R
    query_tiles: int
    n_splits: int       # contiguous target splits, none empty
    split_len: int      # targets per split (the last may hold fewer)
    lanes: int = 1

    @property
    def blocks(self) -> int:
        return self.lanes * self.query_tiles * self.n_splits


_WARPS = 8                # warps per block (csrc/knn.cu: THREADS / 32)
TARGET_BLOCKS = 264       # about two blocks (16 warps) per SM of an H100
_MIN_SPLIT = 64           # shortest split: 2 targets per lane


@functools.lru_cache(maxsize=256)
def _plan(Q: int, M: int, B: int = 1) -> Plan:
    """The grid for B lanes of Q queries and M targets (B, Q, M ≥ 1): two
    queries per warp once one per warp would already give
    :data:`TARGET_BLOCKS` (lane, query tile) blocks, else one; then the
    target splits that bring the grid nearest to :data:`TARGET_BLOCKS`
    blocks, no split shorter than 64 targets, each a multiple of 4 long
    (16-byte aligned starts)."""
    rows = 2 if B * -(-Q // _WARPS) >= TARGET_BLOCKS else 1
    tiles = -(-Q // (_WARPS * rows))
    splits = max(1, min((TARGET_BLOCKS + B * tiles // 2) // (B * tiles),
                        M // _MIN_SPLIT))
    split_len = -(-M // (4 * splits)) * 4
    return Plan(rows, _WARPS * rows, tiles, -(-M // split_len), split_len, B)


_KERNEL = None
# Query tiles sit in grid.y and lanes in grid.z; a launch takes at most
# 65,535 (lane, query tile) pairs (1,048,560 queries at R = 2 in one lane).
MAX_QUERY_TILES = 65535
# Per (device, stream): the kernel's per-(lane, query tile) tickets, one
# for every pair a launch can hold, zeroed once and never replaced (a
# captured CUDA graph keeps their address); each launch leaves them zeroed
# for the next on its stream.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _kernel():
    """The C entry point, built and bound at first use."""
    global _KERNEL
    if _KERNEL is None:
        fn = _build.load("knn").knn5_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def build_kernel() -> None:
    """Build and bind the CUDA kernel now (``nvcc`` at first use, a few
    seconds) without launching it, so that a timed region after this does
    not pay for the build."""
    _kernel()


def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    t = _TICKETS.get((dev.index, stream))
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("call knn_cuda once on this stream before "
                               "capturing it in a CUDA graph")
        t = torch.zeros(MAX_QUERY_TILES, dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def _checked(queries, targets, t_mask, k: int) -> tuple[int, int, int]:
    """(B, Q, M) of inputs the kernel takes: contiguous float32 CUDA
    tensors on one device, queries (B, Q, 3), targets (B, M, 3) with
    M ≥ 1, t_mask (B, M). Raises on anything else. Three expressions, as
    the main path calls this 4 times per sweep."""
    f32 = torch.float32
    dev = queries.device
    B, Q, M = (queries.shape[0] if queries.dim() else -1,
               queries.shape[1] if queries.dim() > 1 else -1,
               targets.shape[1] if targets.dim() > 1 else -1)
    if k != K_DEFAULT:
        raise ValueError(f"the CUDA kernel computes k={K_DEFAULT}, got {k}")
    if queries.dtype != f32 or targets.dtype != f32 or t_mask.dtype != f32:
        raise TypeError(f"the k-NN kernel takes float32 tensors, got "
                        f"{queries.dtype}, {targets.dtype}, {t_mask.dtype}")
    if (dev.type != "cuda" or targets.device != dev or t_mask.device != dev
            or queries.shape != (B, Q, 3) or targets.shape != (B, M, 3)
            or t_mask.shape != (B, M) or M < 1
            or not (queries.is_contiguous() and targets.is_contiguous()
                    and t_mask.is_contiguous())):
        got = ", ".join(
            f"{tuple(x.shape)} on {x.device}"
            + ("" if x.is_contiguous() else " (not contiguous)")
            for x in (queries, targets, t_mask))
        raise ValueError("knn_cuda_lanes takes contiguous CUDA tensors on "
                         "one device: queries (B, Q, 3), targets (B, M, 3) "
                         f"with M >= 1, t_mask (B, M); got {got}")
    return B, Q, M


def knn_cuda_lanes(
    queries: torch.Tensor,     # (B, Q, 3)
    targets: torch.Tensor,     # (B, M, 3)
    t_mask: torch.Tensor,      # (B, M)
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B independent k-NN searches of one shape by the CUDA kernel in one
    launch on the inputs' device's current stream: lane b's queries
    against lane b's masked targets; outputs (B, Q, 5). Inputs: contiguous
    float32 CUDA tensors on one device. The host work per call is kept
    small, since the main path calls this 4 times per sweep: the plan is
    cached, the stream handle is read without building a Stream object,
    and the split scratch (only when the plan splits the targets) is the
    one allocation beside the outputs."""
    global KERNEL_LAUNCHES
    B, Q, M = _checked(queries, targets, t_mask, k)
    dev = queries.device
    idx = torch.empty(B, Q, K_DEFAULT, dtype=torch.int32, device=dev)
    dist = torch.empty(B, Q, K_DEFAULT, dtype=torch.float32, device=dev)
    if Q == 0 or B == 0:
        return idx, dist
    p = _plan(Q, M, B)
    if B * p.query_tiles > MAX_QUERY_TILES:
        raise ValueError(f"the k-NN kernel takes at most {MAX_QUERY_TILES} "
                         f"(lane, query tile) pairs of {p.query_tile} "
                         f"queries, got B={B}, Q={Q}")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = tickets = None
    if p.n_splits > 1:
        scratch = torch.empty(B * Q * p.n_splits * K_DEFAULT,
                              dtype=torch.int64, device=dev)
        tickets = _tickets(dev, stream)
    err = _kernel()(
        queries.data_ptr(), targets.data_ptr(), t_mask.data_ptr(), B, Q, M,
        p.rows, p.n_splits, p.split_len, idx.data_ptr(), dist.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if tickets is None else tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn5_f32 launch failed: cudaError {err}")
    KERNEL_LAUNCHES += 1
    return idx, dist


def knn_cuda(
    queries: torch.Tensor,     # (Q, 3)
    targets: torch.Tensor,     # (M, 3)
    t_mask: torch.Tensor,      # (M,)
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One search by the CUDA kernel: :func:`knn_cuda_lanes` of one
    lane."""
    idx, dist = knn_cuda_lanes(queries[None], targets[None], t_mask[None],
                               k)
    return idx[0], dist[0]


# The CUDA route as a custom op on the lane entry, so that
# ``torch.func.vmap`` reaches the kernel's lane axis: its batching rule
# moves the vmapped axis to the front (expanding an argument without one
# to every lane), folds it into the lanes and calls the op again, so a
# nested vmap folds level by level into one launch.
@torch.library.custom_op("vil_sensor_fusion_tpu_torch::knn5",
                         mutates_args=())
def _knn5(queries: torch.Tensor, targets: torch.Tensor,
          t_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return knn_cuda_lanes(queries, targets, t_mask)


@_knn5.register_vmap
def _knn5_vmap(info, in_dims, queries, targets, t_mask):
    q, t, m = (x.movedim(d, 0) if d is not None
               else x.expand((info.batch_size,) + x.shape)
               for x, d in zip((queries, targets, t_mask), in_dims))
    L, B = q.shape[:2]
    idx, dist = _knn5(*(x.reshape((L * B,) + x.shape[2:]).contiguous()
                        for x in (q, t, m)))
    return (idx.reshape((L, B) + idx.shape[1:]),
            dist.reshape((L, B) + dist.shape[1:])), (0, 0)


def _knn_op(queries, targets, t_mask):
    """One search through the custom op (a lane of one)."""
    idx, dist = _knn5(queries[None], targets[None], t_mask[None])
    return idx[0], dist[0]


def knn(
    queries: torch.Tensor,
    targets: torch.Tensor,
    t_mask: torch.Tensor,
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route by device: CPU → :func:`knn_torch`, CUDA → one lane of
    :func:`knn_cuda_lanes` through the custom op ``knn5`` (one launch for
    all lanes under ``torch.func.vmap``)."""
    if queries.device.type == "cpu":
        return knn_torch(queries, targets, t_mask, k)
    if queries.device.type == "cuda":
        if k != K_DEFAULT:
            raise ValueError(f"the CUDA kernel computes k={K_DEFAULT}, "
                             f"got {k}")
        return _knn_op(queries, targets, t_mask)
    raise ValueError(f"no k-NN path for device {queries.device}")

"""Exact masked k-nearest-neighbour search for ICP correspondence.

Port of ``vil_sensor_fusion_tpu/ops/knn.py``. Both functions here return
``(idx (Q, k) int32, dist² (Q, k))``, ascending, with the lowest target
index first among equal distances and masked targets at +inf:

- :func:`knn_torch` — plain PyTorch: the distance rows
  ‖q‖² − 2q·t + ‖t‖² from one ``torch.matmul``, then k passes of
  lowest-index argmin and mask-out (the selection of the TPU kernel).
- :func:`knn_cuda` — the hand-written Hopper kernel ``csrc/knn.cu``,
  replacing the TPU kernel ``_knn_kernel`` (k = 5, float32 only).

:func:`knn` routes by device: a CPU tensor goes to :func:`knn_torch`, a CUDA
tensor to :func:`knn_cuda`, which raises rather than falling back.
"""

from __future__ import annotations

import ctypes

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    fn = lib.knn5_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def knn_cuda(
    queries: torch.Tensor,
    targets: torch.Tensor,
    t_mask: torch.Tensor,
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN by the CUDA kernel. Inputs: contiguous float32 CUDA tensors on
    one device, queries (Q, 3), targets (M, 3) with M ≥ 1, t_mask (M,)."""
    global KERNEL_LAUNCHES
    if k != K_DEFAULT:
        raise ValueError(f"the CUDA kernel computes k={K_DEFAULT}, got {k}")
    dev = queries.device
    for name, x, shape in (("queries", queries, (queries.shape[0], 3)),
                           ("targets", targets, (targets.shape[0], 3)),
                           ("t_mask", t_mask, (targets.shape[0],))):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Q, M = queries.shape[0], targets.shape[0]
    if M == 0:
        raise ValueError("knn_cuda needs at least one target")
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    dist = torch.empty((Q, k), dtype=torch.float32, device=dev)
    if Q == 0:
        return idx, dist
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn5_f32(queries.data_ptr(), targets.data_ptr(),
                           t_mask.data_ptr(), Q, M, idx.data_ptr(),
                           dist.data_ptr(), stream)
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

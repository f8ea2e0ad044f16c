"""Exact masked k-nearest-neighbour search for ICP correspondence, plain
PyTorch only: ``(idx (Q, k) int32, dist² (Q, k))``, ascending, with the
lowest target index first among equal distances and masked targets at
+inf. The distance rows ‖q‖² − 2q·t + ‖t‖² come from one
``torch.matmul``, so they hold only with TF32 off (see ``_precision``).
"""

from __future__ import annotations

import torch

K_DEFAULT = 5


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


def knn(
    queries: torch.Tensor,
    targets: torch.Tensor,
    t_mask: torch.Tensor,
    k: int = K_DEFAULT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_torch` on any device (``torch.func.vmap`` batches it)."""
    return knn_torch(queries, targets, t_mask, k)

"""The card's peaks and the k-NN kernel's least time.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in float32 outside the tensor cores (the kernel uses none), and
3.35 TB/s of HBM3. The k-NN's work for one launch of B lanes of Q queries
against M targets (``csrc/knn.cu``): 8 FLOP per (query, target) pair (3
subtractions, 3 multiplies and 2 adds of the squared distance), every
input read once (queries and targets as float32 xyz, the float32 mask) and
every output written once (int32 index and float32 distance for k = 5).
"""

from __future__ import annotations

F32_FLOPS = 67e12        # FLOP/s
HBM_BYTES = 3.35e12      # bytes/s
K = 5
FLOP_PER_PAIR = 8


def knn_flops(B: int, Q: int, M: int) -> float:
    return float(FLOP_PER_PAIR) * B * Q * M


def knn_bytes(B: int, Q: int, M: int) -> float:
    return 4.0 * B * (3 * Q + 3 * M + M) + 8.0 * B * Q * K


def knn_bound_s(B: int, Q: int, M: int) -> float:
    """The least time a launch can take on the card: the larger of its
    operations at the f32 peak and its bytes at the HBM peak."""
    return max(knn_flops(B, Q, M) / F32_FLOPS,
               knn_bytes(B, Q, M) / HBM_BYTES)

"""Hand-shaped ops and the CUDA k-NN kernel's wrapper."""

from . import eig3, eig6, knn
from .knn import knn as knn_search, knn_torch

__all__ = ["eig3", "eig6", "knn", "knn_search", "knn_torch"]

"""Pairwise distances and exact k-nearest-neighbour selection.

Port of ``mocopci_tpu/ops/distance.py`` in its exact mode: the k smallest
(distance, index) pairs in ascending order, ties to the lowest index.  The
selection runs in the ``knn_exact`` kernel (CUDA) or its plain twin (CPU).
Channels-last ``(B, N, C)`` throughout.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import knn_exact
from mocopci_torch.kernels.knn import distances

COSINE_EPS = 1e-8


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N, M): ``-2 src·dst + |src|² + |dst|²``."""
    return distances(src, dst, "euclidean")


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + COSINE_EPS)


def cosine_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity with the reference's 1e-8 normalisation eps."""
    return distances(_normalise(src), _normalise(dst), "cosine")


def knn(k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Euclidean k-NN: (B, N, min(k, M)) int32 indices of ``ref`` rows per query."""
    return knn_exact(query.float().contiguous(), ref.float().contiguous(), k, "euclidean")


def knn_cosine(k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Cosine-distance k-NN in feature space (rows normalised first)."""
    return knn_exact(_normalise(query.float()).contiguous(),
                     _normalise(ref.float()).contiguous(), k, "cosine")

"""Pairwise distances and k-nearest-neighbour selection.

Port of ``mocopci_tpu/ops/distance.py``.  ``set_knn_mode`` picks the
selection, with the JAX package's values and default:

- ``"approx"`` (default): the packed-key kNN of the JAX package's TPU path,
  the ``knn_approx`` kernel (CUDA) or its plain twin (CPU);
- ``"exact"``: the k smallest (distance, index) pairs in ascending order,
  ties to the lowest index, the ``knn_exact`` kernel or its twin.

Channels-last ``(B, N, C)`` throughout.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import knn_approx, knn_exact
from mocopci_torch.kernels.knn import distances

COSINE_EPS = 1e-8
MODES = ("approx", "exact")

_KNN_MODE = "approx"


def set_knn_mode(mode: str) -> None:
    """mode: "approx" (packed keys, the default) or "exact" (full top-k)."""
    global _KNN_MODE
    if mode not in MODES:
        raise ValueError(f"knn mode must be one of {MODES}, got {mode!r}")
    _KNN_MODE = mode


def get_knn_mode() -> str:
    return _KNN_MODE


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N, M): ``-2 src·dst + |src|² + |dst|²``."""
    return distances(src, dst, "euclidean")


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + COSINE_EPS)


def cosine_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity with the reference's 1e-8 normalisation eps."""
    return distances(_normalise(src), _normalise(dst), "cosine")


def _select(query: torch.Tensor, ref: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    fn = knn_approx if _KNN_MODE == "approx" else knn_exact
    return fn(query.contiguous(), ref.contiguous(), k, metric)


def knn(k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Euclidean k-NN: (B, N, min(k, M)) int32 indices of ``ref`` rows per query."""
    return _select(query.float(), ref.float(), k, "euclidean")


def knn_cosine(k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Cosine-distance k-NN in feature space (rows normalised first)."""
    return _select(_normalise(query.float()), _normalise(ref.float()), k, "cosine")

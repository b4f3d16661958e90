"""Exact kNN: CUDA kernel ``csrc/knn.cu`` and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/knn.py``: ``exact_knn_pallas`` (:350).
The result is the k smallest (distance, index) pairs in ascending
lexicographic order: ties go to the lowest index, as ``lax.top_k`` gives.
Euclidean rows of at most ``DIRECT_MAX_C`` channels (xyz) are ranked by the
direct sum of squared differences, in channel order and without fused
multiply-adds, so kernel and twin rank by bit-identical distances; wider rows
by the dot forms.  Operations bound it (every query scans every reference row).
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/knn.cu"
REPLACES = "mocopci_tpu/ops/pallas/knn.py:350"

MAX_K = 32
MAX_M = 65536
MAX_C = 512
DIRECT_MAX_C = 8
METRICS = {"euclidean": 0, "cosine": 1}
# distance-matrix entries per chunk of the plain version
_CHUNK = 1 << 22


def distances(query: torch.Tensor, ref: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, N, M) distances in the JAX package's forms: ``(-2 q.r + |q|^2) +
    |r|^2`` for Euclidean, ``1 - q.r`` for cosine on pre-normalised rows."""
    dot = torch.matmul(query, ref.transpose(1, 2))
    if metric == "cosine":
        return 1.0 - dot
    d = -2.0 * dot
    d = d + (query * query).sum(-1, keepdim=True)
    return d + (ref * ref).sum(-1)[:, None, :]


def selection_distances(query: torch.Tensor, ref: torch.Tensor, metric: str) -> torch.Tensor:
    """The (B, N, M) distances the selection ranks (see the module note)."""
    if metric == "cosine" or query.shape[-1] > DIRECT_MAX_C:
        return distances(query, ref, metric)
    d = None
    for c in range(query.shape[-1]):
        diff = query[:, :, None, c] - ref[:, None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def sort_keys(d: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the (distance, index) lexicographic order."""
    bits = (d + 0.0).contiguous().view(torch.int32)     # + 0.0 turns -0 into +0
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)             # monotone in the float
    col = torch.arange(d.shape[-1], device=d.device, dtype=torch.int64)
    return (mono.to(torch.int64) << 32) | col


def knn_plain(query: torch.Tensor, ref: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N, k) int32 indices into ``ref``."""
    M = ref.shape[1]
    k = min(k, M)
    rows = max(1, _CHUNK // max(M, 1))
    out = []
    for s in range(0, query.shape[1], rows):
        keys = sort_keys(selection_distances(query[:, s:s + rows], ref, metric))
        top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
        out.append((top & 0xFFFFFFFF).to(torch.int32))
    return torch.cat(out, dim=1)


def knn_exact(query: torch.Tensor, ref: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    """Exact kNN indices (B, N, min(k, M)) int32; for ``metric="cosine"`` the
    rows must already be normalised.  Kernel on CUDA, twin on the CPU."""
    if metric not in METRICS:
        raise ValueError(f"knn: unknown metric {metric!r}")
    if _lib.dispatch_device(query, ref) == "cpu":
        return knn_plain(query, ref, k, metric)
    _lib.check_cuda("knn query", query, torch.float32, 3)
    _lib.check_cuda("knn ref", ref, torch.float32, 3)
    B, N, C = query.shape
    M = ref.shape[1]
    if ref.shape[0] != B or ref.shape[2] != C:
        raise ValueError(f"knn: shapes {tuple(query.shape)} vs {tuple(ref.shape)}")
    k = min(k, M)
    if not 1 <= k <= MAX_K or M > MAX_M or C > MAX_C:
        raise ValueError(f"knn kernel covers k <= {MAX_K}, M <= {MAX_M}, C <= {MAX_C}; "
                         f"got k={k}, M={M}, C={C}")
    out = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    _lib.launch("knn", query.data_ptr(), ref.data_ptr(), B, N, M, C, k, METRICS[metric],
                out.data_ptr(), _lib.stream(query))
    return out

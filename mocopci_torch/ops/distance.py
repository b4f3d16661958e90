"""Pairwise distances and k-nearest-neighbour selection.

Port of ``mocopci_tpu/ops/distance.py``.  ``set_knn_mode`` picks the
selection, with the JAX package's values and default:

- ``"approx"`` (default): the packed-key kNN of the JAX package's TPU path,
  the ``knn_approx`` kernel (CUDA) or its plain twin (CPU);
- ``"exact"``: the k smallest (distance, index) pairs in ascending order,
  ties to the lowest index, the ``knn_exact`` kernel or its twin up to
  ``knn.MAX_M`` references, :func:`_select_blocked` above (as the TPU path,
  ``mocopci_tpu/ops/distance.py:205-206``).

:func:`_topk_min_indices` and :func:`_select_blocked` follow the JAX
functions of the same names; every selection in them that the TPU runs
through ``lax.top_k`` or the Pallas ``select_min_k`` goes through the
``select_min_k`` kernel here.  Channels-last ``(B, N, C)`` throughout.
"""
from __future__ import annotations

import math

import torch

from mocopci_torch.kernels import knn_approx, knn_exact, select_min_k
from mocopci_torch.kernels import knn as knn_kernel
from mocopci_torch.kernels.knn import distances

COSINE_EPS = 1e-8
MODES = ("approx", "exact")
KNN_RECALL = 0.95       # the JAX package's default recall target

_KNN_MODE = "approx"

# Above this many distance-matrix entries per batch element the selection is
# blocked over query chunks, and references wider than _REF_CHUNK are cut into
# chunks whose top-k survivors are merged (mocopci_tpu/ops/distance.py:147-148).
_DENSE_LIMIT = 1 << 26
_REF_CHUNK = 16384


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


def approx_bins(M: int, k: int, rank: int = 2) -> int:
    """L, the number of candidates ``lax.approx_min_k(..., aggregate_to_topk=False)``
    keeps of M per row: XLA's ``ApproxTopKReductionOutputSize`` (128-lane
    tiling for operands of rank > 1, 1024 for rank 1)."""
    tiling = 1024 if rank == 1 else 128
    if M <= tiling:
        return M
    if k == 1:
        return tiling
    m = min(max(int((1.0 - k) / math.log(KNN_RECALL)), tiling), M)
    log2_red = (M // m).bit_length() - 1
    if log2_red == 0:
        return M
    log2_red = min(log2_red, (M // tiling - 1).bit_length())
    tiles = -(-M // tiling)
    return -(-tiles // (1 << log2_red)) * tiling


def approx_candidates(d: torch.Tensor, k: int):
    """The candidate stage of approx selection, XLA's ``approx_min_k`` with
    ``aggregate_to_topk=False`` in the bin structure the JAX package names
    (``mocopci_tpu/ops/distance.py:197-199``): L = :func:`approx_bins` bins per
    row, bin j holding the columns j, j + L, j + 2L, ...; each bin keeps its
    least value and the lowest column holding it.  L is XLA's; the layout is
    an assumption (XLA does not document it, and its CPU fallback returns the
    L smallest of the row instead).  Returns (vals (..., L),
    idx (..., L) int32, or None when L == M and the bin is the column)."""
    M = d.shape[-1]
    L = approx_bins(M, k, d.dim())
    if L == M:
        return d, None
    n = -(-M // L)
    padded = torch.nn.functional.pad(d, (0, n * L - M), value=float("inf"))
    vals, arg = padded.reshape(d.shape[:-1] + (n, L)).min(dim=-2)
    col = torch.arange(L, dtype=torch.int32, device=d.device)
    return vals, arg.to(torch.int32) * L + col


def _topk_min_indices(dists: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, (..., k) int32,
    k clamped to the row width (``mocopci_tpu/ops/distance.py:85-138``).

    Exact mode: the k least in ascending order, ties to the lowest index, one
    ``select_min_k`` launch for rows up to 16384 (the kernel holds them in
    registers); wider rows that split into 1024-column chunks take each
    chunk's k least, then the k least of those survivors, which is 1.15-1.2x
    faster at 65536-131072 (``scripts/torch_select_timing.py``; JAX chunks
    above 2048 because ``lax.top_k`` sorts the row).  Approx mode: the JAX
    package's TPU path, :func:`approx_candidates` then the ``select_min_k``
    kernel at any L (JAX's ``lax.top_k`` for L <= 2k makes the same stable
    selection)."""
    M = dists.shape[-1]
    k = min(k, M)
    if _KNN_MODE != "approx":
        if M > 16384 and M % 1024 == 0 and k <= 1024:
            nc = M // 1024
            d = dists.reshape(dists.shape[:-1] + (nc, 1024))
            i = select_min_k(d, None, k)                                   # (..., nc, k)
            v = d.gather(-1, i.long()).flatten(-2)
            base = torch.arange(nc, dtype=torch.int32, device=d.device)[:, None] * 1024
            return select_min_k(v, (i + base).flatten(-2), k)
        return select_min_k(dists, None, k)
    return select_min_k(*approx_candidates(dists, k), k)


def _select_blocked(dist_fn, k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """kNN over (B, N, C) queries and (B, M, C) references with at most
    ``_DENSE_LIMIT`` distance entries live per batch element
    (``mocopci_tpu/ops/distance.py:151-192``): query chunks, and above
    ``_REF_CHUNK`` references per-chunk top-k survivors merged by one more
    selection (ties go to the lower chunk, then the lower position)."""
    B, N, _ = query.shape
    M = ref.shape[1]
    k = min(k, M)
    if N * M <= _DENSE_LIMIT:
        return _topk_min_indices(dist_fn(query, ref), k)

    def one_chunk(q):
        if M <= _REF_CHUNK:
            return _topk_min_indices(dist_fn(q, ref), k)
        vals, idxs = [], []
        for lo in range(0, M, _REF_CHUNK):
            d = dist_fn(q, ref[:, lo:lo + _REF_CHUNK])
            pos = _topk_min_indices(d, k)
            vals.append(d.gather(-1, pos.long()))
            idxs.append(pos + lo)
        return select_min_k(torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1), k)

    qb = max(_DENSE_LIMIT // max(M, 1), 128)
    if N <= qb:
        return one_chunk(query)
    n_q = -(-N // qb)
    qpad = torch.nn.functional.pad(query, (0, 0, 0, n_q * qb - N))
    out = [one_chunk(qpad[:, s:s + qb]) for s in range(0, n_q * qb, qb)]
    return torch.cat(out, dim=1)[:, :N]


def _select(query: torch.Tensor, ref: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    fn = knn_approx if _KNN_MODE == "approx" else knn_exact
    return fn(query.contiguous(), ref.contiguous(), k, metric)


def knn(k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Euclidean k-NN: (B, N, min(k, M)) int32 indices of ``ref`` rows per query."""
    if _KNN_MODE != "approx" and ref.shape[1] > knn_kernel.MAX_M:
        return _select_blocked(square_distance, k, ref.float(), query.float())
    return _select(query.float(), ref.float(), k, "euclidean")


def knn_cosine(k: int, ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Cosine-distance k-NN in feature space (rows normalised first)."""
    if _KNN_MODE != "approx" and ref.shape[1] > knn_kernel.MAX_M:
        return _select_blocked(cosine_distance, k, ref.float(), query.float())
    return _select(_normalise(query.float()), _normalise(ref.float()), k, "cosine")

"""Approximate kNN with packed keys: CUDA kernel ``csrc/knn_approx.cu`` and its
plain twin.

Replaces ``mocopci_tpu/ops/pallas/knn.py``: ``fused_knn_pallas`` (:181), the
JAX package's default kNN.  What it computes, exactly:

- a key per (query, reference column): the distance's float bits with the low
  ``idx_bits = bit_length(M - 1)`` bits replaced by the column, compared as
  signed int32 (a slightly negative cosine distance sorts first, unclamped);
- ``tr = min(1024, round_up(M, 128))`` bins per query, ``bin[j]`` the least
  key over the reference tiles' column j (columns past M never enter);
- when ``M > tr`` (and ``k <= 384``) each column mod 128 keeps the 3 least of
  its ``tr / 128`` bins; the k least of the bins (or of those survivors), in
  ascending order, each ``key & mask``, are the neighbours.

Distances: Euclidean with C <= 8 is ``0 + sum_c (q_c - r_c)^2`` in channel
order without fused multiply-adds (as ``csrc/knn.cu``); wider Euclidean rows
``(|q|^2 + |r|^2) - 2 q.r``; cosine ``1 - q.r`` on normalised rows.  Operations
bound it: every query scans every reference row.

The kernel walks over groups of queries.  For Euclidean rows of at most 8
channels a block stages the reference once as coordinate planes (the whole
cloud when it fits in 96 KB) and takes groups of 16 (8 on small grids) until
the grid, about two blocks an SM, has covered them (:func:`launch_grid`);
wider rows take the dot form, a block a group of 16, its products on the
tensor cores.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.knn import (
    DIRECT_MAX_C,
    GROUP,
    METRICS,
    PLANE_BYTES,
    planes_grid,
    selection_distances,
)

SOURCE = "mocopci_torch/csrc/knn_approx.cu"
REPLACES = "mocopci_tpu/ops/pallas/knn.py:181"

TILE = 1024          # reference tile, the JAX kernel's default ``tr``
FOLD_K = 384         # 3 survivors x 128 columns
MAX_C = 512
INF_KEY = 0x7FFFFFFF
# distance-matrix entries per chunk of the plain version
_CHUNK = 1 << 22


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tiling(M: int, k: int):
    """(tr, idx_bits, fold) of the JAX kernel for M reference rows."""
    tr = min(TILE, _round_up(M, 128))
    return tr, max((M - 1).bit_length(), 1), tr // 128 >= 4 and k <= FOLD_K and M > tr


def launch_grid(B: int, N: int, M: int, C: int, tr: int, metric: str):
    """(chunk, blocks along the queries, queries a warp): for Euclidean C <= 8
    ``knn.planes_grid`` over tiles of tr; the dot form a block a group of 16
    (``GROUP``, csrc kDQ)."""
    if metric != "euclidean" or C > DIRECT_MAX_C:
        return 0, -(-N // GROUP), 1
    return planes_grid(B, N, M, C, tr)


def approx_distances(query: torch.Tensor, ref: torch.Tensor, metric: str) -> torch.Tensor:
    """The (B, N, M) distances the JAX kernel packs (see the module note)."""
    if metric == "cosine" or query.shape[-1] <= DIRECT_MAX_C:
        return selection_distances(query, ref, metric)
    qn = (query * query).sum(-1, keepdim=True)
    rn = (ref * ref).sum(-1)[:, None, :]
    return (qn + rn) - 2.0 * torch.matmul(query, ref.transpose(1, 2))


def knn_approx_plain(query: torch.Tensor, ref: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N, k) int32 indices into ``ref``."""
    B, N, _ = query.shape
    M = ref.shape[1]
    k = min(k, M)
    tr, bits, fold = tiling(M, k)
    mask = (1 << bits) - 1
    mpad = _round_up(M, tr)
    col = torch.arange(M, dtype=torch.int32, device=query.device)
    rows = max(1, _CHUNK // mpad)
    out = []
    for s in range(0, N, rows):
        d = approx_distances(query[:, s:s + rows], ref, metric).contiguous()
        key = (d.view(torch.int32) & ~mask) | col
        key = torch.nn.functional.pad(key, (0, mpad - M), value=INF_KEY)
        bins = key.view(B, -1, mpad // tr, tr).amin(2)
        if fold:
            bins = torch.topk(bins.view(B, -1, tr // 128, 128), 3, dim=2, largest=False,
                              sorted=True).values.flatten(2)
        top = torch.topk(bins, k, dim=-1, largest=False, sorted=True).values
        out.append(top & mask)
    return torch.cat(out, dim=1)


def knn_approx(query: torch.Tensor, ref: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    """Approximate kNN indices (B, N, min(k, M)) int32; for ``metric="cosine"``
    the rows must already be normalised.  Kernel on CUDA, twin on the CPU."""
    if metric not in METRICS:
        raise ValueError(f"knn_approx: unknown metric {metric!r}")
    if _lib.dispatch_device(query, ref) == "cpu":
        return knn_approx_plain(query, ref, k, metric)
    _lib.check_cuda("knn_approx query", query, torch.float32, 3)
    _lib.check_cuda("knn_approx ref", ref, torch.float32, 3)
    B, N, C = query.shape
    M = ref.shape[1]
    if ref.shape[0] != B or ref.shape[2] != C:
        raise ValueError(f"knn_approx: shapes {tuple(query.shape)} vs {tuple(ref.shape)}")
    k = min(k, M)
    tr, bits, fold = tiling(M, k)
    if not 1 <= k <= min(tr, FOLD_K) or C > MAX_C:
        raise ValueError(f"knn_approx kernel covers k <= min(tr, {FOLD_K}), C <= {MAX_C}; "
                         f"got k={k}, tr={tr}, C={C}")
    out = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    rn = (ref * ref).sum(-1).contiguous() if metric == "euclidean" and C > DIRECT_MAX_C else ref
    _lib.launch("knn_approx", query.data_ptr(), ref.data_ptr(), rn.data_ptr(), B, N, M, C, k,
                METRICS[metric], tr, bits, int(fold), *launch_grid(B, N, M, C, tr, metric),
                out.data_ptr(), _lib.stream(query))
    return out

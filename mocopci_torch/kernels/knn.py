"""Exact kNN: CUDA kernel ``csrc/knn.cu`` and its plain twin.

Replaces ``mocopci_tpu/ops/pallas/knn.py``: ``exact_knn_pallas`` (:350).
The result is the k smallest (distance, index) pairs in ascending
lexicographic order: ties go to the lowest index, as ``lax.top_k`` gives.
Euclidean rows of at most ``DIRECT_MAX_C`` channels (xyz) are ranked by the
direct sum of squared differences, in channel order and without fused
multiply-adds, so kernel and twin rank by bit-identical distances; wider rows
by the dot forms.  Operations bound it (every query scans every reference row).

The xyz rows take a threshold and one filtered scan: a block stages the
reference as coordinate planes (the whole cloud when it fits, as
``knn_approx``; :func:`launch_grid`), keeps 256 bins of least distances a
query, bounds the k-th neighbour's distance by the k-th least bin, and sorts
the columns within that bound (at most ``CAP`` a query).  A query with more goes
the overflow route inside the kernel (a sorted list a lane, merged); each such
query adds one to the device counter that :func:`overflows` reads.  The dot
form keeps a sorted list a query over up to ``MAX_SPLITS`` spans of the
reference, a block each, merged by a second kernel (:func:`launch_grid`).
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
BIN_TILE = 256       # columns a bin tile (csrc kBinTile): bin b holds columns b mod 256
CAP = 64             # candidates a query keeps for its sort (csrc kCap)
GROUP = 16           # queries a group: 8 warps x 2 (csrc kXWarps x QW)
PLANE_BYTES = 96 * 1024   # the staged coordinate planes, at most (csrc kXPlaneBytes)
SMS = 132            # an H100's SMs
DOT_QUERIES = 64     # queries a block of the dot form (csrc kDotQ)
DOT_ROWS = 32        # reference rows a tile of the dot form (csrc kDotR)
MAX_SPLITS = 16      # spans of the reference in the dot form (csrc kMaxSplits)
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


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def planes_grid(B: int, N: int, M: int, C: int, tile: int):
    """(chunk, blocks along the queries, queries a warp) of a kernel that
    stages the reference as coordinate planes (Euclidean, C <= 8; this one's
    and ``knn_approx``'s): the rows a block stages (whole tiles, the whole
    cloud when it fits), 2 queries a warp (groups of 16) where that still
    gives every SM two blocks, else 1 (groups of 8), and, when one chunk
    holds the cloud, enough blocks for two an SM over the B clouds, each
    taking every gx-th group; otherwise (a streamed reference) a block a
    group."""
    planes = 3 if C == 3 else DIRECT_MAX_C
    chunk = min(_round_up(M, tile), PLANE_BYTES // (4 * planes) // tile * tile)
    qw = 2 if B * -(-N // GROUP) >= 2 * SMS else 1
    groups = -(-N // (GROUP // 2 * qw))
    return chunk, (min(groups, -(-2 * SMS // B)) if chunk >= M else groups), qw


def launch_grid(B: int, N: int, M: int, C: int, metric: str):
    """The filtered scan's :func:`planes_grid` over bin tiles; for the dot
    form (span, splits, 0): the reference rows a split scans (whole tiles)
    and the splits, enough for two blocks an SM where the query blocks alone
    do not fill the card, at most ``MAX_SPLITS``."""
    if metric == "euclidean" and C <= DIRECT_MAX_C:
        return planes_grid(B, N, M, C, BIN_TILE)
    blocks = B * -(-N // DOT_QUERIES)
    splits = max(1, min(MAX_SPLITS, -(-2 * SMS // blocks)))
    span = _round_up(-(-M // splits), DOT_ROWS)
    return span, -(-M // span), 0


_OVERFLOW: dict = {}


def _overflow_counter(device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in _OVERFLOW:
        _OVERFLOW[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _OVERFLOW[key]


def overflows() -> int:
    """Queries that took the overflow route since the last
    :func:`reset_overflows`, over every device (reads the device counters)."""
    return sum(int(t.item()) for t in _OVERFLOW.values())


def reset_overflows() -> None:
    for t in _OVERFLOW.values():
        t.zero_()


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
    grid = launch_grid(B, N, M, C, metric)
    dot = metric != "euclidean" or C > DIRECT_MAX_C
    # the dot form's split lists: (distance bits, index) pairs
    part = torch.empty((B, N, grid[1], k, 2) if dot and grid[1] > 1 else (0,),
                       dtype=torch.int32, device=query.device)
    _lib.launch("knn", query.data_ptr(), ref.data_ptr(), B, N, M, C, k, METRICS[metric], *grid,
                out.data_ptr(), part.data_ptr(), _overflow_counter(query.device).data_ptr(),
                _lib.stream(query))
    return out

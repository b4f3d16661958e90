"""Approximate Earth Mover's Distance, forward (port of ``mocopci_tpu/ops/emd.py``).

The annealing match of the reference CUDA extension: 10 levels
``-4^j`` (j = 7..-1) then 0; soft mass assignment with remaining capacity on
both sides, the integer-division capacity init; ``cost = Σ match·‖p1 − p2‖²``.
The JAX package computes all of it in XLA, outside any Pallas kernel, so the
port uses PyTorch ops and ``torch.matmul`` (float32, TF32 off: see
``mocopci_torch.device``), with the exact ``exp``.

Two forms, as in JAX: the dense one holds the (B, m, n) match matrix; the
blocked one keeps only the per-level ratio vectors (the match is separable per
level) and evaluates every kernel matvec with the distance tile recomputed in
query chunks.  ``earth_mover_distance_auto`` takes the blocked one above
``EMD_DENSE_LIMIT`` entries (so at 8192², unchunked at B = 1).
"""
from __future__ import annotations

import torch

from mocopci_torch.ops.distance import square_distance

LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1)) + (0.0,)
EMD_DENSE_LIMIT = 1 << 24     # entries of one (n, m) matrix
EMD_TILE_ENTRIES = 1 << 26    # entries of the (B, chunk, m) tile of a blocked matvec
EMD_CHUNK = 1024              # smallest chunk


def _capacity(n: int, m: int):
    """Integer-division capacity init (``emd_kernel.cu:33-39``)."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def _bmv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, n, m) x (B, m) -> (B, n)."""
    return torch.matmul(mat, v[..., None])[..., 0]


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate bipartite match (B, m, n) of (B, n, 3) and (B, m, 3) clouds
    (rows index xyz2, as the CUDA op)."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    d = square_distance(xyz1, xyz2)                          # (B, n, m)
    multi_l, multi_r = _capacity(n, m)
    match = xyz1.new_zeros((B, m, n))
    remain_l = xyz1.new_full((B, n), multi_l)
    remain_r = xyz1.new_full((B, m), multi_r)
    for level in LEVELS:
        kern = torch.exp(level * d)
        ratio_l = remain_l / (_bmv(kern, remain_r) + 1e-9)
        sumr = _bmv(kern.transpose(1, 2), ratio_l) * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        w = kern * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + w.transpose(1, 2)
        remain_l = torch.clamp(remain_l - w.sum(2), min=0.0)
    return match


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """Σ match·‖p1−p2‖² per batch element: (B,)."""
    d = square_distance(xyz1, xyz2)                          # (B, n, m)
    return (match.transpose(1, 2) * d).sum((1, 2))


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate EMD cost per batch element (B,), dense form."""
    return match_cost(xyz1, xyz2, approx_match(xyz1, xyz2))


def _chunk_for(nb: int, batch: int = 1) -> int:
    per_b = EMD_TILE_ENTRIES // max(nb * batch, 1)
    return max(per_b // 1024 * 1024, EMD_CHUNK)


def _kernel_matvec(level: float, xa: torch.Tensor, xb: torch.Tensor, v: torch.Tensor,
                   vd: torch.Tensor = None):
    """``out[b,n] = Σ_m exp(level·d[b,n,m]) v[b,m,:]`` and, with ``vd``,
    ``outd[b,n] = Σ_m exp(level·d)·d·vd[b,m,:]``; xa (B, na, 3), xb (B, nb, 3),
    v (B, nb, C).  The query axis goes in chunks, each recomputing its tile."""
    chunk = _chunk_for(xb.shape[1], xa.shape[0])
    outs, outds = [], []
    for xa_c in torch.split(xa, chunk, dim=1):
        d = square_distance(xa_c, xb)
        kern = torch.exp(level * d)
        outs.append(torch.matmul(kern, v))
        if vd is not None:
            outds.append(torch.matmul(kern * d, vd))
    out = torch.cat(outs, dim=1)
    return out if vd is None else (out, torch.cat(outds, dim=1))


def _annealing_vectors(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The annealing loop with blockwise matvecs: the per-level ratio vectors
    (L, B, n), (L, B, m) and the match cost (B,) accumulated on the way."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = _capacity(n, m)
    remain_l = xyz1.new_full((B, n), multi_l)
    remain_r = xyz1.new_full((B, m), multi_r)
    rls, rrs, cost = [], [], xyz1.new_zeros(B)
    for level in LEVELS:
        suml = _kernel_matvec(level, xyz1, xyz2, remain_r[..., None])[..., 0] + 1e-9
        ratio_l = remain_l / suml
        sumr = _kernel_matvec(level, xyz2, xyz1, ratio_l[..., None])[..., 0] * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        kr, krd = _kernel_matvec(level, xyz1, xyz2, ratio_r[..., None], ratio_r[..., None])
        cost = cost + (ratio_l * krd[..., 0]).sum(1)
        remain_l = torch.clamp(remain_l - ratio_l * kr[..., 0], min=0.0)
        rls.append(ratio_l)
        rrs.append(ratio_r)
    return torch.stack(rls), torch.stack(rrs), cost


def earth_mover_distance_blocked(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Memory-bounded approximate EMD (B,); the dense form's semantics."""
    return _annealing_vectors(xyz1, xyz2)[2]


def earth_mover_distance_auto(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Per-sample EMD cost (B,): blocked above ``EMD_DENSE_LIMIT`` entries."""
    if xyz1.shape[1] * xyz2.shape[1] > EMD_DENSE_LIMIT:
        return earth_mover_distance_blocked(xyz1, xyz2)
    return earth_mover_distance(xyz1, xyz2)


def emd(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Mean EMD normalised by point count (ref ``EMD``, ``models/utils.py:223-235``)."""
    return earth_mover_distance_auto(pc1, pc2).mean() / pc1.shape[1]

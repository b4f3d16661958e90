"""Chamfer distance (port of ``mocopci_tpu/ops/chamfer.py``).

Bidirectional squared-distance Chamfer: per point the least squared distance
to the other cloud, a mean over points in each direction, the two directions
summed.  The port takes the JAX package's TPU route on every device: the
``chamfer_pair`` kernel where ``supported(N, M)``, otherwise two directed 1-NN
queries through ``knn_approx`` (k = 1, whatever the kNN mode), each distance
recomputed exactly from the selected neighbour.  Channels-last ``(B, N, 3)``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mocopci_torch.kernels import chamfer_pair, knn_approx
from mocopci_torch.kernels.chamfer_pair import supported
from mocopci_torch.ops.distance import square_distance
from mocopci_torch.ops.sampling import gather


def _directed_min(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared distance from each src point to its selected dst neighbour: (B, N)."""
    idx = knn_approx(src, dst, 1, "euclidean")[..., 0]
    diff = src - gather(dst, idx)
    return (diff * diff).sum(-1)


def _pair_means(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Per-sample bidirectional Chamfer (B,)."""
    pc1, pc2 = pc1.float().contiguous(), pc2.float().contiguous()
    if supported(pc1.shape[1], pc2.shape[1]):
        d12, d21 = chamfer_pair(pc1, pc2)
    else:
        d12, d21 = _directed_min(pc1, pc2), _directed_min(pc2, pc1)
    return d12.mean(1) + d21.mean(1)


def chamfer_distance(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Bidirectional Chamfer distance, scalar (batch mean); (B, N, 3), (B, M, 3)."""
    return _pair_means(pc1, pc2).mean()


def chamfer_distance_per_sample(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Per-sample bidirectional Chamfer: (B,). Used by the eval loop."""
    return _pair_means(pc1, pc2)


def chamfer_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """``chamfer_distance`` of each of K same-shape pairs, (K,), from one
    folded (K·B) call."""
    K, B = len(pairs), pairs[0][0].shape[0]
    src = torch.cat([p for p, _ in pairs], dim=0)
    dst = torch.cat([q for _, q in pairs], dim=0)
    return _pair_means(src, dst).reshape(K, B).mean(-1)


def chamfer_distance_blocked(pc1: torch.Tensor, pc2: torch.Tensor,
                             block: int = 2048) -> torch.Tensor:
    """Memory-bounded dense Chamfer for large clouds: the query axis in
    ``block``-row chunks, so only a (B, block, M) slab is live at a time."""

    def directed(src, dst):
        N = src.shape[1]
        nb = max(N // block, 1)
        mins = [square_distance(c, dst).amin(-1) for c in torch.split(src, N // nb, dim=1)]
        return torch.cat(mins, dim=1).mean(1)

    return (directed(pc1, pc2) + directed(pc2, pc1)).mean()

"""Sampling and gathering ops (port of ``mocopci_tpu/ops/sampling.py``).

FPS runs in the ``fps`` kernel (CUDA) or its plain twin (CPU); the pyramid is
one launch per level with a gather in between, each level's indices
addressing the previous level's cloud.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mocopci_torch.kernels import fps
from mocopci_torch.kernels._lib import group_rows


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32; index 0 first, greedy argmax."""
    return fps(xyz.float().contiguous(), int(npoint))


def farthest_point_sample_pyramid(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple:
    """Cascaded FPS: level l samples ``npoints[l]`` from the level-(l-1) subset.

    Returns one (B, npoints[l]) int32 index tensor per level, each addressing
    the PREVIOUS level's sampled cloud (level 0 addresses ``xyz``).
    """
    idxs = []
    pc = xyz.float().contiguous()
    for n in npoints:
        i = farthest_point_sample(pc, n)
        pc = gather(pc, i).contiguous()
        idxs.append(i)
    return tuple(idxs)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows: (B, N, C) x (B, S) -> (B, S, C)."""
    return group_rows(points, idx)


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Grouped gather: (B, N, C) x (B, S, K) -> (B, S, K, C)."""
    return group_rows(points, idx)


def group_multi(idx: torch.Tensor, *arrays: torch.Tensor):
    """Gather several (B, N, C_i) tensors with the same indices in one pass."""
    if len(arrays) == 1:
        return (group(arrays[0], idx),)
    widths = [a.shape[-1] for a in arrays]
    g = group(torch.cat(arrays, dim=-1), idx)
    return tuple(torch.split(g, widths, dim=-1))

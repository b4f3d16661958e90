"""Sampling and gathering ops (port of ``mocopci_tpu/ops/sampling.py``).

FPS runs in the ``fps`` kernel (CUDA) or its plain twin (CPU); the pyramid in
the ``fps_pyramid`` kernel, every level in one launch, each level's indices
addressing the previous level's cloud (on the CPU its twin: a loop of
``fps_plain`` and gathers).  A gather's backward is
``kernels.scatter_add.gather_backward``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mocopci_torch.kernels import fps, fps_pyramid
from mocopci_torch.kernels._lib import group_rows
from mocopci_torch.kernels.scatter_add import gather_backward


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32; index 0 first, greedy argmax."""
    return fps(xyz.float().contiguous(), int(npoint))


def farthest_point_sample_pyramid(xyz: torch.Tensor, npoints: Sequence[int]) -> Tuple:
    """Cascaded FPS: level l samples ``npoints[l]`` from the level-(l-1) subset.

    Returns one (B, npoints[l]) int32 index tensor per level, each addressing
    the PREVIOUS level's sampled cloud (level 0 addresses ``xyz``).
    """
    return fps_pyramid(xyz.float().contiguous(), npoints)


class _RowGather(torch.autograd.Function):
    """Row gather whose backward is :func:`gather_backward`: the deterministic
    ``scatter_add`` kernel where the JAX gather VJP takes its Pallas scatter,
    ``index_add_`` elsewhere."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = points.shape[1]
        return group_rows(points, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, C = g.shape[0], g.shape[-1]
        d = gather_backward(g.reshape(B, -1, C), idx.reshape(B, -1), ctx.n_rows)
        return d, None


def _row_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and points.requires_grad:
        return _RowGather.apply(points, idx)
    return group_rows(points, idx)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows: (B, N, C) x (B, S) -> (B, S, C)."""
    return _row_gather(points, idx)


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Grouped gather: (B, N, C) x (B, S, K) -> (B, S, K, C)."""
    return _row_gather(points, idx)


def group_multi(idx: torch.Tensor, *arrays: torch.Tensor):
    """Gather several (B, N, C_i) tensors with the same indices in one pass."""
    if len(arrays) == 1:
        return (group(arrays[0], idx),)
    widths = [a.shape[-1] for a in arrays]
    g = group(torch.cat(arrays, dim=-1), idx)
    return tuple(torch.split(g, widths, dim=-1))

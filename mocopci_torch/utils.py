"""Reference-named utility API (port of ``mocopci_tpu/utils.py``).

Channels-first wrappers with the names and conventions of the reference's
``models/utils.py``: ``chamfer_loss`` and ``EMD`` take (B, 3, N) clouds.
``ClippedStepLR`` comes with the training port.
"""
from __future__ import annotations

import torch

from mocopci_torch import ops


def chamfer_loss(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Bidirectional Chamfer on channels-first clouds (B, 3, N)."""
    return ops.chamfer_distance(pc1.transpose(1, 2), pc2.transpose(1, 2))


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         transpose: bool = True) -> torch.Tensor:
    """Approx EMD cost per batch element (B,); inputs (B, 3, N) if transpose."""
    if xyz1.dim() == 2:
        xyz1 = xyz1[None]
    if xyz2.dim() == 2:
        xyz2 = xyz2[None]
    if transpose:
        xyz1, xyz2 = xyz1.transpose(1, 2), xyz2.transpose(1, 2)
    return ops.earth_mover_distance(xyz1, xyz2)


def EMD(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Mean EMD / point count on channels-first clouds (B, 3, M)."""
    return ops.emd(pc1.transpose(1, 2), pc2.transpose(1, 2))


def pdist2squared(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, 3, N) x (B, 3, M) -> (B, N, M) squared distances, clamped at 0."""
    return torch.clamp(ops.square_distance(x.transpose(1, 2), y.transpose(1, 2)), min=0.0)


def flow_criterion(pred_flow: torch.Tensor, flow: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked mean half-squared flow error (ref ``models/utils.py:32-34``)."""
    return torch.mean(mask * torch.sum((pred_flow - flow) ** 2, dim=1) / 2.0)

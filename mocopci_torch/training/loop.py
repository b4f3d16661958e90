"""Eval step (port of ``eval_step`` in ``mocopci_tpu/training/loop.py``).

The train step, its optimizer and checkpoints come with the training port.
"""
from __future__ import annotations

from typing import Dict

import torch

from mocopci_torch import ops


@torch.no_grad()
def eval_step(model, batch: Dict, with_emd: bool = True) -> Dict[str, torch.Tensor]:
    """One forward and the per-frame metrics of the reference eval loop.

    ``batch`` holds 'pc1', 'pc2' (B, N, 3) and 'gt' (B, F, N, 3), numpy or
    tensors.  Returns :func:`eval_metrics` of the (B, F, N, 3) output.
    """
    model.eval()
    pc1, pc2, gt = (torch.as_tensor(batch[k], dtype=torch.float32, device=model.device)
                    for k in ("pc1", "pc2", "gt"))
    return eval_metrics(model(pc1, pc2)["out"], gt, with_emd)


@torch.no_grad()
def eval_metrics(out: torch.Tensor, gt: torch.Tensor,
                 with_emd: bool = True) -> Dict[str, torch.Tensor]:
    """``cd_j`` and, with EMD, ``emd_j`` (each (B,), on the output's device)
    for frames j < F of (B, F, N, 3) clouds: the Chamfer with the frame axis
    folded into the batch (one call for all frames), the EMD per frame
    divided by N."""
    B, F, N, _ = out.shape
    cd = ops.chamfer_distance_per_sample(out.reshape(B * F, N, 3),
                                         gt.reshape(B * F, N, 3)).reshape(B, F)
    metrics = {}
    for j in range(F):
        metrics[f"cd_{j}"] = cd[:, j]
        if with_emd:
            metrics[f"emd_{j}"] = ops.earth_mover_distance_auto(out[:, j], gt[:, j]) / N
    return metrics

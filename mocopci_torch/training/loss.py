"""Training loss (port of ``mocopci_tpu/training/loss.py``), all Chamfer:

  loss_f   = Σ_frames CD(out[j], gt[j])                      (full-res outputs)
  loss_s_* = w_straight · Σ_frames (CD(warped[j], gt[j]) + CD(reverse-warped[j], gt[j]))
  loss_m_* = Σ_l alpha[l+1] · Σ_frames CD(pyramid_l[j], gt_pyr[l+1][j])
  total    = loss_f + (loss_s_f + loss_s_b)/2 + w_multi · (loss_m_f + loss_m_b)

The ground-truth pyramid is one FPS launch at the largest level with prefix
slices (greedy FPS is prefix-consistent).  Pairs of one cloud size share one
folded ``chamfer_many`` call.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from mocopci_torch import ops
from mocopci_torch.config import ModelConfig, TrainConfig


# the loss components mocopci_loss returns, in this order
LOSS_KEYS = ("loss", "loss_f", "loss_s_f", "loss_s_b", "loss_m_f", "loss_m_b")


def gt_pyramid(gt: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    """gt (B, F, N, 3) -> ((B, F, n_l, 3) for n_l in [N, n1, n2, n3])."""
    B, F, N, _ = gt.shape
    flat = gt.reshape(B * F, N, 3).float().contiguous()
    idx = ops.farthest_point_sample(flat, max(cfg.pyramid[:3]))
    out = [gt]
    for n in cfg.pyramid[:3]:
        out.append(ops.gather(flat, idx[:, :n]).reshape(B, F, n, 3))
    return tuple(out)


def mocopci_loss(result: Dict, gt: torch.Tensor, model_cfg: ModelConfig,
                 train_cfg: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``result``: the train forward's ``out`` and ``frames_f`` / ``frames_b``;
    gt (B, F, N, 3).  Returns (total, components), the JAX package's aux keys."""
    B, F = gt.shape[:2]
    alpha = train_cfg.alpha
    pyr = gt_pyramid(gt, model_cfg)
    frames_f, frames_b = result["frames_f"], result["frames_b"]

    def fold(x):
        return x.reshape(B * F, x.shape[2], 3)

    gt0 = fold(pyr[0])
    cd8k = ops.chamfer_many([
        (fold(result["out"]), gt0),
        (fold(frames_f[0]), gt0),
        (fold(frames_f[1]), gt0),
        (fold(frames_b[0]), gt0),
        (fold(frames_b[1]), gt0),
    ]) * F
    loss_f = cd8k[0]
    loss_s_f = train_cfg.w_straight * (cd8k[1] + cd8k[2])
    loss_s_b = train_cfg.w_straight * (cd8k[3] + cd8k[4])

    loss_m_f = loss_m_b = 0.0
    for level in range(len(alpha) - 1):
        cdl = ops.chamfer_many([
            (fold(frames_f[level + 2]), fold(pyr[level + 1])),
            (fold(frames_b[level + 2]), fold(pyr[level + 1])),
        ]) * F
        loss_m_f = loss_m_f + alpha[level + 1] * cdl[0]
        loss_m_b = loss_m_b + alpha[level + 1] * cdl[1]

    total = loss_f + (loss_s_f + loss_s_b) / 2.0 + train_cfg.w_multi * (loss_m_f + loss_m_b)
    aux = {"loss": total, "loss_f": loss_f, "loss_s_f": loss_s_f, "loss_s_b": loss_s_b,
           "loss_m_f": loss_m_f, "loss_m_b": loss_m_b}
    return total, aux

"""Learning-rate schedule (port of ``mocopci_tpu/training/schedule.py``): the
reference's epoch-level StepLR clamped below,
``lr(epoch) = max(lr0 · gamma^(epoch // step), clip)``, indexed by the step."""
from __future__ import annotations

from mocopci_torch.config import TrainConfig


def lr_at(cfg: TrainConfig, step: int, steps_per_epoch: int) -> float:
    epoch = step // max(steps_per_epoch, 1)
    return max(cfg.lr * cfg.lr_gamma ** (epoch // cfg.lr_step), cfg.lr_clip)

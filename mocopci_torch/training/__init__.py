"""Training-side entry points of the port: the train state and step (one
device, or data-parallel over ``torch.distributed``), the loss, the schedule,
checkpoints and the eval step."""
from mocopci_torch.training.checkpoint import CheckpointManager
from mocopci_torch.training.loop import (
    TrainState,
    create_train_state,
    dp_train_step,
    eval_metrics,
    eval_step,
    train_step,
)
from mocopci_torch.training.loss import gt_pyramid, mocopci_loss
from mocopci_torch.training.schedule import lr_at

__all__ = ["CheckpointManager", "TrainState", "create_train_state", "dp_train_step",
           "eval_metrics", "eval_step", "gt_pyramid", "lr_at", "mocopci_loss", "train_step"]

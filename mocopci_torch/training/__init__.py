"""Training-side entry points of the port (so far the eval step)."""
from mocopci_torch.training.loop import eval_metrics, eval_step

__all__ = ["eval_metrics", "eval_step"]

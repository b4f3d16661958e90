"""Checkpoints of the port's train state, in its own format: one
``torch.save`` file per saved epoch with the model's ``state_dict``, the
optimizer's, the step, the epoch, the epoch's metrics and the steps per epoch
the learning-rate schedule was built on.  Written to a temporary name and
renamed, so a file that exists is whole; the newest ``max_to_keep`` stay.
Under data parallelism rank 0 writes and every rank waits at a barrier
until the file is there; every rank restores (the directory must be one
that every rank sees).  (Restoring the JAX package's Orbax checkpoints is
not ported.)
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

from mocopci_torch.parallel import barrier, world
from mocopci_torch.training.loop import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self):
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState, metrics: Optional[Dict] = None,
             steps_per_epoch: int = 0) -> None:
        """Rank 0 writes; every rank calls, and returns once the file is whole."""
        if world()[0] == 0:
            self._write(epoch, state, metrics, steps_per_epoch)
        barrier()

    def _write(self, epoch: int, state: TrainState, metrics: Optional[Dict],
               steps_per_epoch: int) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "epoch": epoch,
            "metrics": dict(metrics or {}),
            "steps_per_epoch": steps_per_epoch,
        }
        tmp = self._path(epoch) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state: TrainState, epoch: Optional[int] = None) -> Tuple[TrainState, int]:
        """Loads ``epoch`` (default: the latest) into ``state`` in place;
        returns (state, the saved steps per epoch; 0 when not recorded)."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(epoch), map_location=state.model.device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, int(payload["steps_per_epoch"])

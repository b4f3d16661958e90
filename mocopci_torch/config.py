"""Model configuration of the PyTorch port (its own copy; see ``mocopci_tpu/config.py``).

Defaults mirror the reference architecture exactly: pyramid 8192/2048/512/256/64,
encoder channels 32/64/128/256/256, kNN sizes 32/32/16/32 and the hard-coded
frame timestamps.  ``tiny_model_config`` keeps the structure at test size;
``stress_model_config`` is the dense-stress configuration of 16k-32k points.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def timestamps(
    t_begin: float = 0.0,
    t_end: float = 1.0,
    interval: int = 4,
    num_frames: int = 4,
) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Forward and backward frame timestamps from the CLI flags.

    With the default flags this returns bit-for-bit the model's literals
    ``ModelConfig.t_forward`` / ``t_backward``.  The one-shot synthesis head
    emits exactly ``interval - 1 = 3`` frames and NL-Drive rows carry 4 input
    frames, so other values are rejected.
    """
    if interval != 4:
        raise ValueError(
            f"--interval must be 4 (got {interval}): the one-shot frame "
            "synthesis head emits interval-1=3 frames and the NL-Drive row "
            "contract provides exactly 3 ground-truth frames"
        )
    if num_frames != 4:
        raise ValueError(
            f"--num_frames must be 4 (got {num_frames}): NL-Drive rows carry "
            "4 input frames (01/05/09/13)"
        )
    time_seq = np.linspace(t_begin, t_end, num_frames)
    t_left, t_right = time_seq[num_frames // 2 - 1], time_seq[num_frames // 2]
    intp = np.linspace(t_left, t_right, interval + 1)[1:-1]
    t_forward = (float(t_begin),) + tuple(float(x) for x in intp) + (float(t_end),)
    return t_forward, tuple(reversed(t_forward))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture configuration (the production model by default)."""

    npoints: int = 8192
    # FPS pyramid, levels 1..4
    pyramid: Tuple[int, int, int, int] = (2048, 512, 256, 64)
    # intermediate frames predicted in one shot
    n_frames: int = 3
    enc_channels: Tuple[int, int, int, int, int] = (32, 64, 128, 256, 256)
    weightnet: int = 8
    feat_nei: int = 32       # encoder kNN group size
    flow_nei: int = 32       # cross / bidirectional / flow-embedding kNN size
    refine_k: int = 16       # point-transformer kNN in the refine head
    fusion_k: int = 32       # kNN-softmax fusion neighbourhood
    t_forward: Tuple[float, ...] = (0.0, 0.41666666666666663, 0.5, 0.5833333333333333, 1.0)
    t_backward: Tuple[float, ...] = (1.0, 0.5833333333333333, 0.5, 0.41666666666666663, 0.0)
    # dropout rates of the attention decoder blocks (train only)
    attn_drop: float = 0.05
    proj_drop: float = 0.05
    drop_path: float = 0.04
    # refine head downsample size
    refine_npoint: int = 2048
    # decoder rematerialisation under autodiff: not ported yet, must stay False
    remat: bool = False

    @property
    def levels(self) -> Tuple[int, int, int, int, int]:
        return (self.npoints,) + self.pyramid

    def validate(self) -> None:
        n0, (n1, n2, n3, n4) = self.npoints, self.pyramid
        if not n0 >= n1 >= n2 >= n3 >= n4 >= 1:
            raise ValueError(f"pyramid must shrink: {self.levels}")
        if self.refine_npoint > n0:
            raise ValueError(f"refine_npoint {self.refine_npoint} > npoints {n0}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe; the defaults are the reference recipe (B=2, AdamW 1e-3
    with decoupled weight decay 1e-4, StepLR 15 epochs x 0.8 clamped at 5e-5,
    global-norm clip 2.0, the multi-scale Chamfer loss weights)."""

    batch_size: int = 2
    epochs: int = 400
    lr: float = 1e-3
    weight_decay: float = 1e-4
    lr_step: int = 15          # StepLR step_size, epochs
    lr_gamma: float = 0.8      # StepLR gamma
    lr_clip: float = 5e-5      # the learning rate's floor
    grad_clip: float = 2.0     # global-norm clip
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 0
    alpha: Tuple[float, float, float, float] = (1.0, 0.8, 0.4, 0.2)
    w_straight: float = 0.5
    w_multi: float = 0.25
    # the batch runs as grad_accum sequential micro-batches whose mean
    # gradient makes one update; BatchNorm statistics chain through them
    grad_accum: int = 1


def stress_model_config(npoints: int) -> ModelConfig:
    """Dense-stress configuration (16k-32k points a frame): the FPS pyramid at
    the 8192-point model's ratios (/4, /16, /32, /128) and the refine head at
    npoints / 4; every width and kNN size as in ``ModelConfig()``.  Above 8192
    points FPS level 0 runs across a thread-block cluster (``kernels.fps``)."""
    return ModelConfig(
        npoints=npoints,
        pyramid=(npoints // 4, npoints // 16, npoints // 32, npoints // 128),
        refine_npoint=npoints // 4,
    )


def tiny_model_config(npoints: int = 256) -> ModelConfig:
    """A small config with the same structure, for tests and CPU dry runs."""
    return ModelConfig(
        npoints=npoints,
        pyramid=(npoints // 4, npoints // 8, npoints // 16, npoints // 32),
        feat_nei=8,
        flow_nei=8,
        refine_k=4,
        fusion_k=8,
        refine_npoint=npoints // 4,
    )

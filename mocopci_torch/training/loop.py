"""Train and eval steps (port of ``mocopci_tpu/training/loop.py``), one device.

``train_step`` is forward, loss and backward over ``grad_accum`` micro-batches
(BatchNorm running statistics chain through them, as in JAX's scan), the mean
gradient, a global-norm clip at 2.0 with optax's rule (scale by clip / norm
only when norm >= clip; no epsilon in the norm, unlike
``torch.nn.utils.clip_grad_norm_``), then AdamW (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay 1e-4) at the clipped StepLR rate of the step.
``dp_train_step`` is the data-parallel step over ``torch.distributed``, the
port of JAX's shard_map step (``make_sharded_train_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mocopci_torch import ops
from mocopci_torch.config import ModelConfig, TrainConfig
from mocopci_torch.models import MoCoPCI
from mocopci_torch.training.loss import LOSS_KEYS, mocopci_loss
from mocopci_torch.training.schedule import lr_at


@dataclasses.dataclass
class TrainState:
    model: MoCoPCI
    optimizer: torch.optim.Optimizer
    model_cfg: ModelConfig
    train_cfg: TrainConfig
    steps_per_epoch: int
    step: int = 0


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    """AdamW over every parameter; the rate is set per step by :func:`train_step`."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
                             eps=cfg.adam_eps, weight_decay=cfg.weight_decay)


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, steps_per_epoch: int,
                       device=None) -> Tuple[MoCoPCI, TrainState]:
    """A model with weights drawn from ``train_cfg.seed`` (on the card unless
    ``device`` says otherwise) and its optimizer."""
    model = MoCoPCI(model_cfg, device=device, seed=train_cfg.seed)
    return model, TrainState(model, make_optimizer(model, train_cfg), model_cfg, train_cfg,
                             steps_per_epoch)


def _as_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
            for k in ("pc1", "pc2", "gt")}


def loss_and_grads(model: MoCoPCI, batch: Dict, rng: Optional[torch.Generator],
                   model_cfg: ModelConfig, train_cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """Fills every parameter's ``.grad`` with the batch's mean gradient over
    ``grad_accum`` micro-batches (zeros where a parameter gets none, as optax
    sees them) and returns the mean loss components."""
    b = _as_batch(batch, model.device)
    B, K = b["pc1"].shape[0], train_cfg.grad_accum
    if K < 1 or B % K:
        raise ValueError(f"batch size {B} not divisible by grad_accum {K}")
    model.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for k in range(K):
        sl = slice(k * B // K, (k + 1) * B // K)
        result = model(b["pc1"][sl], b["pc2"][sl], train=True, rng=rng)
        total, aux = mocopci_loss(result, b["gt"][sl], model_cfg, train_cfg)
        (total / K).backward()
        for name, v in aux.items():
            sums[name] = sums.get(name, 0.0) + v.detach()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return {name: v / K for name, v in sums.items()}


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``; returns the
    norm before clipping."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def apply_update(state: TrainState) -> torch.Tensor:
    """Clip, then one AdamW step at the step's rate; returns the gradient norm."""
    norm = clip_by_global_norm(list(state.model.parameters()), state.train_cfg.grad_clip)
    lr = lr_at(state.train_cfg, state.step, state.steps_per_epoch)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return norm


def train_step(state: TrainState, batch: Dict,
               rng: Optional[torch.Generator] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """batch: 'pc1', 'pc2' (B, N, 3) and 'gt' (B, F, N, 3), numpy or tensors.
    ``rng``: a generator on the model's device for dropout (None: no dropout).
    Returns the state (updated in place) and the loss components with
    ``grad_norm``, as 0-d tensors on the device."""
    aux = loss_and_grads(state.model, batch, rng, state.model_cfg, state.train_cfg)
    aux["grad_norm"] = apply_update(state)
    return state, aux


def dp_train_step(state: TrainState, batch: Dict, rng: Optional[torch.Generator] = None,
                  n_data: Optional[int] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The data-parallel train step (JAX's shard_map step): ``batch`` holds
    this rank's rows of the global batch (``parallel.host_batch_slice``),
    which the unchanged one-device :func:`loss_and_grads` takes in
    ``grad_accum`` micro-batches; then one all-reduce over the default process
    group of one flat buffer that holds every ``.grad`` (the zeros included),
    the loss components and the BatchNorm running statistics after this
    rank's EMA, divided by ``n_data``, the ranks that hold rows (default: the
    world size).  A rank given no rows adds zeros.  Batch statistics stay per
    rank, as ``torch.nn.DataParallel``'s and JAX's shard_map's do.  The clip
    and AdamW then run alike on every rank (``grad_norm`` from the mean
    gradients), so the parameters stay bit-equal across ranks.  ``rng``: this
    rank's own generator (``parallel.rank_generator``).  Without a process
    group it is :func:`train_step`."""
    if not (dist.is_available() and dist.is_initialized()):
        return train_step(state, batch, rng)
    model = state.model
    n_data = dist.get_world_size() if n_data is None else n_data
    has_rows = len(batch["pc1"]) > 0
    if has_rows:
        aux = loss_and_grads(model, batch, rng, state.model_cfg, state.train_cfg)
    else:
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        aux = {k: torch.zeros((), device=model.device) for k in LOSS_KEYS}
    grads = [p.grad for p in model.parameters()]
    values = [aux[k] for k in LOSS_KEYS]
    stats = [b for b in model.buffers() if b.is_floating_point()]
    parts = grads + values + stats
    flat = torch.cat([t.reshape(-1) for t in parts])
    if not has_rows:
        flat.zero_()
    dist.all_reduce(flat)
    flat /= n_data
    for t, m in zip(parts, flat.split([t.numel() for t in parts])):
        t.copy_(m.view_as(t))
    aux = dict(zip(LOSS_KEYS, values))
    aux["grad_norm"] = apply_update(state)
    return state, aux


@torch.no_grad()
def eval_step(model, batch: Dict, with_emd: bool = True) -> Dict[str, torch.Tensor]:
    """One forward and the per-frame metrics of the reference eval loop.

    ``batch`` holds 'pc1', 'pc2' (B, N, 3) and 'gt' (B, F, N, 3), numpy or
    tensors.  Returns :func:`eval_metrics` of the (B, F, N, 3) output.
    """
    model.eval()
    b = _as_batch(batch, model.device)
    return eval_metrics(model(b["pc1"], b["pc2"])["out"], b["gt"], with_emd)


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

"""Basic building blocks (port of ``mocopci_tpu/nn/basic.py``), channels-last.

Every reference Conv1d/Conv2d is a 1x1 convolution, i.e. a ``Dense`` over the
last axis.  Module and parameter names follow the flax tree, so
``bridge.params_from_jax`` maps one onto the other by name.

Train mode follows the JAX modules' arguments: ``train`` switches BatchNorm to
batch statistics (and their running EMA), and a ``torch.Generator`` passed as
``rng`` turns dropout and stochastic depth on (``rng=None`` is JAX's
``deterministic=True``).  The port's random stream is its own, not flax's.
Under remat (``ModelConfig.remat``) a checkpointed stage runs twice; its
recompute replays the forward's draws and leaves the running statistics
alone (``frozen_running_stats``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_RATE = 0.1


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale by 1/(1 - rate);
    the identity when ``rng`` is None or the rate is 0."""
    if rng is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
              sample_ndim: int = 2) -> torch.Tensor:
    """Stochastic depth over the leading ``sample_ndim`` axes ((batch, frames)
    in the decoder, as the reference's per-item loop makes frames the sample)."""
    if rng is None or rate == 0.0:
        return x
    shape = x.shape[:sample_ndim] + (1,) * (x.dim() - sample_ndim)
    keep = torch.rand(shape, generator=rng, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Linear):
    """``nn.Linear`` whose initialisation is drawn by :func:`init_weights` from
    an explicit generator.  ``init_std`` set = normal(0, init_std) (the
    reference's truncated-normal 0.02 layers), else normal(0, 1/sqrt(fan_in))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_std: Optional[float] = None):
        self.init_std = init_std
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self) -> None:
        # values come from init_weights(generator); keep construction free of
        # the global RNG
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every Dense weight of ``module`` from ``generator`` (biases zero)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                std = m.init_std if m.init_std is not None else m.in_features ** -0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)


class PReLU(nn.Module):
    """Single-parameter PReLU, init 0.25."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class ConvLReLU(nn.Module):
    """Dense + LeakyReLU(0.1): the reference's composed Conv1d/Conv2d module."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = Dense(in_features, features)

    def forward(self, x):
        return F.leaky_relu(self.conv(x), LEAKY_RATE)


class WeightNet(nn.Module):
    """MLP on grouped relative xyz: (..., 3) -> (..., out), ReLU after each layer."""

    def __init__(self, out_channel: int, hidden: Sequence[int] = (8, 8)):
        super().__init__()
        widths = (3,) + tuple(hidden)
        for i in range(len(hidden)):
            setattr(self, f"conv{i}", Dense(widths[i], widths[i + 1]))
        self.n_hidden = len(hidden)
        self.conv_out = Dense(widths[-1], out_channel)

    def forward(self, x):
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return torch.relu(self.conv_out(x))


class Mlp(nn.Module):
    """ViT MLP with tanh-approximate GELU (flax ``nn.gelu``), for the EI FFN."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EasyMlp(nn.Module):
    """Dense -> PReLU -> dropout -> Dense -> dropout."""

    def __init__(self, in_features: int, hidden: int, out: int, drop: float = 0.05):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(in_features, hidden, init_std=0.02)
        self.act = PReLU()
        self.fc2 = Dense(hidden, out, init_std=0.02)

    def forward(self, x, rng=None):
        x = dropout(self.act(self.fc1(x)), self.drop, rng)
        return dropout(self.fc2(x), self.drop, rng)


class MlpT(nn.Module):
    """Dense -> depthwise 1x1 (per-channel scale + shift) -> PReLU -> dropout
    -> Dense -> dropout."""

    def __init__(self, in_features: int, hidden: int, out: int, drop: float = 0.05):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(in_features, hidden, init_std=0.02)
        self.dw_scale = nn.Parameter(torch.ones(hidden))
        self.dw_bias = nn.Parameter(torch.zeros(hidden))
        self.act = PReLU()
        self.fc2 = Dense(hidden, out, init_std=0.02)

    def forward(self, x, rng=None):
        x = self.fc1(x) * self.dw_scale + self.dw_bias
        x = dropout(self.act(x), self.drop, rng)
        return dropout(self.fc2(x), self.drop, rng)


class FrameBatchNorm(nn.Module):
    """BatchNorm over all axes but the leading and the channel one, per
    leading item (the reference normalises each batch item on its own), over
    the last axis; with ``grouped_cf`` over axis 2 of (G, B, C, P) planes, per
    group.  ``train``: batch statistics, and the running statistics move by
    an EMA (momentum 0.1) of the items' mean and *unbiased* variance; else
    the running statistics.  While ``frozen`` (a remat recompute) the running
    statistics stay as they are."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.frozen = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def ema_update(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Running statistics from per-item batch statistics (items, C) with
        ``n`` elements each (JAX's ``ema_stats=(mean, var, n)``)."""
        if self.frozen:
            return
        unbiased = var * (n / max(n - 1, 1))
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean.mean(dim=0))
        self.running_var.mul_(1 - m).add_(m * unbiased.mean(dim=0))

    def forward(self, x, train: bool = False, grouped_cf: bool = False):
        x = x.float()
        w, b = self.weight, self.bias
        if grouped_cf:
            w, b = w[:, None], b[:, None]
        if not train:
            mean, var = self.running_mean, self.running_var
            if grouped_cf:
                mean, var = mean[:, None], var[:, None]
            return (x - mean) * torch.rsqrt(var + self.eps) * w + b
        axes = (1, 3) if grouped_cf else tuple(range(1, x.dim() - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
        n = 1
        for a in axes:
            n *= x.shape[a]
        self.ema_update(mean.reshape(x.shape[0], -1), var.reshape(x.shape[0], -1), n)
        return (x - mean) * torch.rsqrt(var + self.eps) * w + b


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within: no ``FrameBatchNorm`` of ``module`` moves its running statistics
    (a remat recompute, which must not apply the step's EMA a second time)."""
    norms = [m for m in module.modules() if isinstance(m, FrameBatchNorm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False

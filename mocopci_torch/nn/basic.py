"""Basic building blocks (port of ``mocopci_tpu/nn/basic.py``), channels-last.

Every reference Conv1d/Conv2d is a 1x1 convolution, i.e. a ``Dense`` over the
last axis.  Module and parameter names follow the flax tree, so
``bridge.params_from_jax`` maps one onto the other by name.  Eval only:
dropout and stochastic depth are identities there, so no module of the port
calls them; the train slice adds them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_RATE = 0.1


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
    """Dense -> PReLU -> Dense (dropout is an identity in eval)."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, init_std=0.02)
        self.act = PReLU()
        self.fc2 = Dense(hidden, out, init_std=0.02)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class MlpT(nn.Module):
    """Dense -> depthwise 1x1 (per-channel scale + shift) -> PReLU -> Dense."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, init_std=0.02)
        self.dw_scale = nn.Parameter(torch.ones(hidden))
        self.dw_bias = nn.Parameter(torch.zeros(hidden))
        self.act = PReLU()
        self.fc2 = Dense(hidden, out, init_std=0.02)

    def forward(self, x):
        x = self.fc1(x) * self.dw_scale + self.dw_bias
        return self.fc2(self.act(x))


class FrameBatchNorm(nn.Module):
    """Eval BatchNorm with running statistics over the last axis, or over
    axis 2 of (G, B, C, P) planes with ``grouped_cf``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, grouped_cf: bool = False):
        if self.training:
            raise NotImplementedError("FrameBatchNorm batch statistics are not ported yet")
        x = x.float()
        mean, var, w, b = self.running_mean, self.running_var, self.weight, self.bias
        if grouped_cf:
            mean, var, w, b = (t[:, None] for t in (mean, var, w, b))
        return (x - mean) * torch.rsqrt(var + self.eps) * w + b

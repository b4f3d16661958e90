"""PointConv layers (port of ``mocopci_tpu/nn/pointconv.py``), channels-last.

kNN grouping -> WeightNet on relative xyz -> per-point (C x K)(K x W)
aggregation -> Dense -> LeakyReLU.  ``PointConvD`` FPS-downsamples the queries.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mocopci_torch import ops
from mocopci_torch.nn.basic import LEAKY_RATE, Dense, WeightNet


def _pointconv_core(weightnet: WeightNet, linear: Dense, query_xyz, grouped_rows):
    """query_xyz (B, S, 3), grouped_rows (B, S, K, 3+D) raw [xyz | feat] rows
    -> (B, S, out).  Only the xyz part is made relative to the query."""
    B, S, K, C = grouped_rows.shape
    q = query_xyz[:, :, None, :]
    rel = grouped_rows[..., :3] - q
    new_points = torch.cat([rel, grouped_rows[..., 3:]], dim=-1)     # (B,S,K,C)
    weights = weightnet(rel)                                          # (B,S,K,W)
    agg = torch.matmul(new_points.transpose(2, 3), weights)           # (B,S,C,W)
    return F.leaky_relu(linear(agg.reshape(B, S, -1)), LEAKY_RATE)


def _aggregate_linear(nsample: int, fan_in: int, out_channel: int) -> Dense:
    """The Dense after the neighbour aggregation, which sums ``nsample``
    products: drawn with std 1/(nsample·sqrt(fan_in)) so that a random model's
    activations stay of order one down the pyramid (at 1/sqrt(fan_in) they grow
    with every level, and the output of a random ``ModelConfig()`` model turns
    on float rounding)."""
    return Dense(fan_in, out_channel, init_std=fan_in ** -0.5 / nsample)


class PointConv(nn.Module):
    """Same-resolution PointConv: kNN among the points themselves."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int, weightnet: int = 8):
        super().__init__()
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet)
        self.linear = _aggregate_linear(nsample, (3 + in_channel) * weightnet, out_channel)

    def forward(self, xyz, feat):
        """xyz (B, N, 3), feat (B, N, D) -> (B, N, out)."""
        idx = ops.knn(self.nsample, xyz, xyz)
        rows = ops.group(torch.cat([xyz, feat], dim=-1), idx)
        return _pointconv_core(self.weightnet, self.linear, xyz, rows)


class PointConvD(nn.Module):
    """Downsampling PointConv: FPS to ``npoint`` queries, then grouped conv."""

    def __init__(self, npoint: int, nsample: int, in_channel: int, out_channel: int,
                 weightnet: int = 8):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet)
        self.linear = _aggregate_linear(nsample, (3 + in_channel) * weightnet, out_channel)

    def forward(self, xyz, feat, fps_idx=None):
        """-> (new_xyz (B, npoint, 3), out (B, npoint, out)).  ``fps_idx``
        supplies precomputed FPS indices (the encoder's pyramid)."""
        if fps_idx is None:
            fps_idx = ops.farthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather(xyz, fps_idx)
        idx = ops.knn(self.nsample, xyz, new_xyz)
        rows = ops.group(torch.cat([xyz, feat], dim=-1), idx)
        return new_xyz, _pointconv_core(self.weightnet, self.linear, new_xyz, rows)

"""Cost-volume / correlation layers (port of ``mocopci_tpu/nn/cross.py``).

  - ``CrossLayerFeatCosine``: dual-kNN cost volume (half the neighbours by
    cosine distance in feature space, half by Euclidean distance in xyz).
  - ``BidirectionalLayerFeatCosine``: symmetric cross feature update; its
    Euclidean half queries from the OTHER cloud into this one, as the
    reference was trained.
  - ``FlowEmbeddingLayer``: motion embedding between pc1 and the warped pc2.

The post-gather tail (add, leaky, Dense, leaky, max over neighbours) runs in
the ``cross_tail`` kernel for N1 >= 1024 with one MLP layer, as the JAX
package dispatches its Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mocopci_torch import ops
from mocopci_torch.kernels import cross_tail
from mocopci_torch.nn.basic import LEAKY_RATE, ConvLReLU, Dense

KERNEL_MIN_N = 1024


def _dual_knn_indices(k_half, xyz1, xyz2, knn1, knn2, idx_cos=None):
    """Cosine-feature + Euclidean-xyz neighbour indices, (B, N1, 2·k_half)."""
    if idx_cos is None:
        idx_cos = ops.knn_cosine(k_half, knn2, knn1)
    idx_euc = ops.knn(k_half, xyz2, xyz1)
    return torch.cat([idx_cos, idx_euc], dim=-1)


def _cross_core(pos: Dense, mlp: Sequence[ConvLReLU], xyz1, xyz2, points1, points2, idx):
    """Gather, position-encode, MLP, max-pool over neighbours -> (B, N1, C).

    pos is linear, so pos(nbr - x1) = pos(nbr) - (pos(x1) - bias): the table
    pos(xyz2) + points2 is gathered once and the query terms form ``base``.
    """
    tab = (pos(xyz2.float()) + points2.float()).contiguous()
    base = (points1.float() - (pos(xyz1.float()) - pos.bias)).contiguous()
    if len(mlp) == 1 and xyz1.shape[1] >= KERNEL_MIN_N:
        conv = mlp[0].conv
        return cross_tail(tab, idx.contiguous(), base, conv.weight.t().contiguous(),
                          conv.bias.contiguous())
    x = F.leaky_relu(ops.group(tab, idx) + base[:, :, None, :], LEAKY_RATE)
    for layer in mlp:
        x = layer(x)
    return x.amax(dim=2)


def _mlp_layers(owner: nn.Module, prefix: str, widths: Sequence[int]):
    layers = []
    for i in range(1, len(widths)):
        layer = ConvLReLU(widths[i - 1], widths[i])
        owner.add_module(f"{prefix}_{i - 1}", layer)
        layers.append(layer)
    return layers


class CrossLayerFeatCosine(nn.Module):
    """L3 cost volume; only the two directional features are computed."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int], mlp2: Sequence[int]):
        super().__init__()
        self.nsample = nsample
        self.pos1 = Dense(3, mlp1[0])
        self.cross_t11 = Dense(in_channel, mlp1[0])
        self.cross_t22 = Dense(in_channel, mlp1[0])
        self.mlp1_layers = _mlp_layers(self, "mlp1", mlp1)
        self.cross_t1 = Dense(mlp1[-1], mlp2[0])
        self.cross_t2 = Dense(mlp1[-1], mlp2[0])

    def _dir(self, proj, pc_q, pc_r, feat_q, feat_r, knn_q, knn_r):
        idx = _dual_knn_indices(self.nsample // 2, pc_q, pc_r, knn_q, knn_r)
        out = _cross_core(self.pos1, self.mlp1_layers, pc_q, pc_r,
                          self.cross_t11(feat_q), self.cross_t22(feat_r), idx)
        return proj(out)

    def forward(self, pc1, pc2, feat1, feat2, knn1, knn2):
        feat1_new = self._dir(self.cross_t1, pc1, pc2, feat1, feat2, knn1, knn2)
        feat2_new = self._dir(self.cross_t2, pc2, pc1, feat2, feat1, knn2, knn1)
        return feat1_new, feat2_new


class BidirectionalLayerFeatCosine(nn.Module):
    """Symmetric cross feature update."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int]):
        super().__init__()
        self.nsample = nsample
        self.pos = Dense(3, mlp[0])
        self.cross_t11 = Dense(in_channel, mlp[0])
        self.cross_t22 = Dense(in_channel, mlp[0])
        self.mlp_layers = _mlp_layers(self, "mlp", mlp)

    def one_direction(self, pc_q, pc_r, feat_q, feat_r, knn_q, knn_r, idx_cos=None):
        k = self.nsample // 2
        if idx_cos is None:
            idx_cos = ops.knn_cosine(k, knn_r, knn_q)
        idx_euc = ops.knn(k, pc_q, pc_r)     # swapped: reference set is THIS cloud
        idx = torch.cat([idx_cos, idx_euc], dim=-1)
        return _cross_core(self.pos, self.mlp_layers, pc_q, pc_r,
                           self.cross_t11(feat_q), self.cross_t22(feat_r), idx)

    def forward(self, pc1, pc2, feat1, feat2, knn1, knn2, idx_cos_12=None, idx_cos_21=None):
        feat1_new = self.one_direction(pc1, pc2, feat1, feat2, knn1, knn2, idx_cos_12)
        feat2_new = self.one_direction(pc2, pc1, feat2, feat1, knn2, knn1, idx_cos_21)
        return feat1_new, feat2_new


class FlowEmbeddingLayer(nn.Module):
    """Motion embedding between pc1 and the warped pc2."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int]):
        super().__init__()
        self.nsample = nsample
        self.pos = Dense(3, mlp[0])
        self.conv1 = Dense(in_channel, mlp[0])
        self.conv2 = Dense(in_channel, mlp[0])
        self.mlp_layers = _mlp_layers(self, "mlp", mlp)

    def forward(self, pc1, pc2, feat1, feat2, knn1, knn2, idx_cos=None):
        idx = _dual_knn_indices(self.nsample // 2, pc1, pc2, knn1, knn2, idx_cos)
        return _cross_core(self.pos, self.mlp_layers, pc1, pc2,
                           self.conv1(feat1), self.conv2(feat2), idx)

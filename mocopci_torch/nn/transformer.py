"""Point-transformer block of the refine head (port of
``mocopci_tpu/nn/transformer.py``): kNN vector attention with subtraction
logits ``fc_gamma(q - k + pos)``, softmax over the neighbours scaled by
sqrt(d_model), aggregation of ``v + pos``.  For N >= 1024 the pair chain runs
in the ``transformer_tail`` kernel, as the JAX package dispatches its Pallas
kernel."""
from __future__ import annotations

import math

import torch
from torch import nn

from mocopci_torch import ops
from mocopci_torch.kernels import transformer_tail
from mocopci_torch.nn.basic import Dense

KERNEL_MIN_N = 1024


class PointTransformerBlock(nn.Module):
    def __init__(self, d_model: int, k: int = 16):
        super().__init__()
        self.d_model = d_model
        self.k = k
        D = d_model
        self.fc1 = Dense(D, D)
        self.w_qs = Dense(D, D, bias=False)
        self.w_ks = Dense(D, D, bias=False)
        self.w_vs = Dense(D, D, bias=False)
        self.fc_delta1 = Dense(3, D)
        self.fc_delta2 = Dense(D, D)
        self.fc_gamma1 = Dense(D, D)
        self.fc_gamma2 = Dense(D, D)
        self.fc2 = Dense(D, D)

    def forward(self, features, xyz):
        """features (B, N, d_model), xyz (B, N, 3) -> (B, N, d_model)."""
        idx = ops.knn(self.k, xyz, xyz)
        x = self.fc1(features)
        q, ks, vs = self.w_qs(x), self.w_ks(x), self.w_vs(x)
        if xyz.shape[1] >= KERNEL_MIN_N:
            weights = []
            for m in (self.fc_delta1, self.fc_delta2, self.fc_gamma1, self.fc_gamma2):
                weights += [m.weight.t().contiguous(), m.bias.contiguous()]
            table = torch.cat([xyz.float(), ks, vs], dim=-1).contiguous()
            res = transformer_tail(table, idx.contiguous(), xyz.float().contiguous(),
                                   q.contiguous(), *weights)
            return self.fc2(res) + features
        knn_xyz, k_g, v_g = ops.group_multi(idx, xyz, ks, vs)
        rel = xyz[:, :, None, :] - knn_xyz
        pos = self.fc_delta2(torch.relu(self.fc_delta1(rel)))
        attn = self.fc_gamma2(torch.relu(self.fc_gamma1(q[:, :, None] - k_g + pos)))
        attn = torch.softmax(attn / math.sqrt(self.d_model), dim=2)
        res = torch.sum(attn * (v_g + pos), dim=2)
        return self.fc2(res) + features

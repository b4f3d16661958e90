"""3-NN inverse-distance interpolation, upsampling and warping
(port of ``mocopci_tpu/ops/interpolate.py``).  Channels-last (B, N, C)."""
from __future__ import annotations

import torch

from mocopci_torch.ops.distance import knn
from mocopci_torch.ops.sampling import group_multi


def _inverse_distance_weights(query_xyz: torch.Tensor, neigh: torch.Tensor) -> torch.Tensor:
    """Normalised 1/d weights over k gathered neighbours (B, N, k, 3); d >= 1e-10."""
    diff = neigh - query_xyz[:, :, None, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-20)
    w = 1.0 / torch.clamp(dist, min=1e-10)
    return w / torch.sum(w, dim=-1, keepdim=True)


def upsample(dense_xyz, sparse_xyz, sparse_feat, k: int = 3):
    """Interpolate (B, S, C) features from a sparse to a dense point set: (B, N, C)."""
    idx = knn(k, sparse_xyz, dense_xyz)
    neigh, feats = group_multi(idx, sparse_xyz, sparse_feat)
    w = _inverse_distance_weights(dense_xyz, neigh)
    return torch.sum(w[..., None] * feats, dim=2)


def upsample_multi(dense_xyz, sparse_xyz, sparse_feats, k: int = 3):
    """Upsample several fields on the same sparse geometry with one kNN + gather."""
    idx = knn(k, sparse_xyz, dense_xyz)
    gathered = group_multi(idx, sparse_xyz, *sparse_feats)
    w = _inverse_distance_weights(dense_xyz, gathered[0])[..., None]
    return [torch.sum(w * g, dim=2) for g in gathered[1:]]


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(dists (B, N, 3) l2, idx (B, N, 3) int32) of the 3 nearest ``known`` points."""
    idx = knn(3, known, unknown)
    neigh = group_multi(idx, known)[0]
    diff = neigh - unknown[:, :, None, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1)), idx


def three_interpolate(dense_xyz, sparse_xyz, sparse_feat):
    """three_nn + inverse-distance weighted gather: ``upsample`` with k=3."""
    return upsample(dense_xyz, sparse_xyz, sparse_feat, k=3)


def point_warp(xyz1, xyz2, flow1):
    """Inverse warping of cloud 2 toward cloud 1's flow field: (B, N2, 3)."""
    xyz1_to_2 = xyz1 + flow1
    idx = knn(3, xyz1_to_2, xyz2)
    neigh, flows = group_multi(idx, xyz1_to_2, flow1)
    w = _inverse_distance_weights(xyz2, neigh)
    flow2 = torch.sum(w[..., None] * flows, dim=2)
    return xyz2 - flow2

"""Fusion head pair kernel: CUDA ``csrc/fusion_pair.cu`` and its plain twin.

One kernel replaces three TPU kernels: ``gather_planes.py``
``bucket_gather_pair_planes`` (:87), the ``fusion_planes.py``
``build_pair_planes`` forward (:148) and ``fusion_head.py``
``fusion_head_pallas`` (:66).  Pairs are k-major, p = j·N + n.  BatchNorm is
folded into the dense weights on the host (:func:`fold_bn_dense`).
Operations bound it.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib

SOURCE = "mocopci_torch/csrc/fusion_pair.cu"
REPLACES = "mocopci_tpu/ops/pallas/gather_planes.py:87; mocopci_tpu/ops/pallas/fusion_planes.py:148; mocopci_tpu/ops/pallas/fusion_head.py:66"

EPS = 1e-20  # under the sqrt, as the JAX package
WIDTHS = (4, 64, 64, 128)


def fold_bn_dense(weight, bias, scale, bn_bias, mean, var, eps):
    """Fold eval BatchNorm into the preceding dense layer; weight is (in, out).

    ((x W + b) - mean) * rsqrt(var + eps) * scale + bn_bias
      = x (W s) + ((b - mean) s + bn_bias),  s = scale * rsqrt(var + eps)
    """
    s = scale * torch.rsqrt(var + eps)
    return weight * s[None, :], (bias - mean) * s + bn_bias


def pair_planes(points2, idx, points1):
    """(G, N2, 3), (G, N, K2), (G, N, 3) -> (G, 4, N·K2) [resi_xyz, dist] planes."""
    G, N, K2 = idx.shape
    off = torch.arange(G, device=idx.device).view(G, 1, 1) * points2.shape[1]
    flat = (idx.long() + off).transpose(1, 2).reshape(-1)             # k-major
    nbr = points2.reshape(-1, 3)[flat].reshape(G, K2 * N, 3).transpose(1, 2)
    resi = nbr - points1.transpose(1, 2).repeat(1, 1, K2)
    dist = torch.sqrt(torch.sum(resi * resi, dim=1, keepdim=True) + EPS)
    return torch.cat([resi, dist], dim=1)


def fusion_pair_plain(points2, idx, points1, w1, b1, w2, b2, w3, b3):
    """Returns (planes (G, 4, P), logits (G, P)), P = N·K2."""
    planes = pair_planes(points2, idx, points1)
    h = planes
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = torch.relu(torch.einsum("gcp,cd->gdp", h, w) + b[:, None])
    return planes, h.amax(dim=1)


def fusion_pair(points2, idx, points1, w1, b1, w2, b2, w3, b3):
    """Kernel on CUDA, twin on the CPU."""
    weights = (w1, b1, w2, b2, w3, b3)
    if _lib.dispatch_device(points2, idx, points1, *weights) == "cpu":
        return fusion_pair_plain(points2, idx, points1, *weights)
    _lib.check_cuda("fusion_pair points2", points2, torch.float32, 3)
    _lib.check_cuda("fusion_pair idx", idx, torch.int32, 3)
    _lib.check_cuda("fusion_pair points1", points1, torch.float32, 3)
    G, N, K2 = idx.shape
    N2 = points2.shape[1]
    if points2.shape != (G, N2, 3) or points1.shape != (G, N, 3):
        raise ValueError("fusion_pair: inconsistent shapes")
    for i, t in enumerate(weights):
        layer = i // 2
        want = (WIDTHS[layer], WIDTHS[layer + 1]) if i % 2 == 0 else (WIDTHS[layer + 1],)
        _lib.check_cuda(f"fusion_pair weight {i}", t, torch.float32, len(want))
        if tuple(t.shape) != want:
            raise ValueError(f"fusion_pair kernel is built for widths {WIDTHS}; "
                             f"weight {i} is {tuple(t.shape)}")
    P = N * K2
    planes = torch.empty((G, 4, P), dtype=torch.float32, device=points2.device)
    logits = torch.empty((G, P), dtype=torch.float32, device=points2.device)
    _lib.launch("fusion_pair", points2.data_ptr(), idx.data_ptr(), points1.data_ptr(),
                *(t.data_ptr() for t in weights), planes.data_ptr(), logits.data_ptr(),
                G, N, N2, K2, _lib.stream(points2))
    return planes, logits

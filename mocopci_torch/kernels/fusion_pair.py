"""Fusion head pair kernel: CUDA ``csrc/fusion_pair.cu`` and its plain twin.

One kernel replaces three TPU kernels: ``gather_planes.py``
``bucket_gather_pair_planes`` (:87), the ``fusion_planes.py``
``build_pair_planes`` forward (:148) and ``fusion_head.py``
``fusion_head_pallas`` (:66).  Pairs are k-major, p = j·N + n.  BatchNorm is
folded into the dense weights on the host (:func:`fold_bn_dense`).
Operations bound it.  The train path takes the planes alone
(:func:`fusion_pair_planes`, a second entry of the same source; bytes bound
it) and scores them with ``fusion_head_train``.
"""
from __future__ import annotations

import torch

from mocopci_torch.kernels import _lib
from mocopci_torch.kernels.scatter_add import scatter_add

SOURCE = "mocopci_torch/csrc/fusion_pair.cu"
REPLACES = "mocopci_tpu/ops/pallas/gather_planes.py:87; mocopci_tpu/ops/pallas/fusion_planes.py:148; mocopci_tpu/ops/pallas/fusion_head.py:66"
REPLACES_PLANES = "mocopci_tpu/ops/pallas/gather_planes.py:87"

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


def _check_points(points2, idx, points1, name):
    _lib.check_cuda(f"{name} points2", points2, torch.float32, 3)
    _lib.check_cuda(f"{name} idx", idx, torch.int32, 3)
    _lib.check_cuda(f"{name} points1", points1, torch.float32, 3)
    G, N, K2 = idx.shape
    N2 = points2.shape[1]
    if points2.shape != (G, N2, 3) or points1.shape != (G, N, 3):
        raise ValueError(f"{name}: inconsistent shapes")
    return G, N, N2, K2


def fusion_pair_planes_kernel(points2, idx, points1):
    """The planes-only kernel entry: (G, 4, N·K2) on the card."""
    G, N, N2, K2 = _check_points(points2, idx, points1, "fusion_pair_planes")
    planes = torch.empty((G, 4, N * K2), dtype=torch.float32, device=points2.device)
    _lib.launch("fusion_pair_planes", points2.data_ptr(), idx.data_ptr(), points1.data_ptr(),
                planes.data_ptr(), G, N, N2, K2, _lib.stream(points2))
    return planes


class _PairPlanes(torch.autograd.Function):
    """The train path's planes with the backward of ``_gpp_bwd``
    (``mocopci_tpu/ops/pallas/fusion_planes.py:253-267``): d_resi = dx[0:3] +
    dx[3]·resi/dist, d_points2 through the ``scatter_add`` kernel (plane
    form), d_points1 = −Σ_j d_resi over the k-major neighbour slots."""

    @staticmethod
    def forward(ctx, points2, idx, points1):
        if _lib.dispatch_device(points2, idx, points1) == "cpu":
            planes = pair_planes(points2, idx, points1)
        else:
            planes = fusion_pair_planes_kernel(points2, idx, points1)
        ctx.save_for_backward(planes, idx)
        ctx.n2 = points2.shape[1]
        return planes

    @staticmethod
    def backward(ctx, dx):
        planes, idx = ctx.saved_tensors
        G, N, K2 = idx.shape
        d_resi = dx[:, 0:3] + dx[:, 3:4] * (planes[:, 0:3] / planes[:, 3:4])   # (G, 3, P)
        idx_km = idx.transpose(1, 2).reshape(G, K2 * N).contiguous()
        d_p2 = scatter_add(d_resi.contiguous(), idx_km, ctx.n2, planes=True)
        d_p1 = -d_resi.reshape(G, 3, K2, N).sum(dim=2).transpose(1, 2)
        return d_p2, None, d_p1


def fusion_pair_planes(points2, idx, points1):
    """(G, N2, 3), (G, N, K2) int32, (G, N, 3) -> (G, 4, N·K2) [resi, dist]
    planes, k-major; the kernel on CUDA, the twin on the CPU; differentiable
    in both clouds."""
    return _PairPlanes.apply(points2, idx, points1)


def fusion_pair(points2, idx, points1, w1, b1, w2, b2, w3, b3):
    """Eval only (BatchNorm folded): the kernel on CUDA, the twin on the CPU.
    The kernel has no backward, so on CUDA it refuses inputs that would need one."""
    weights = (w1, b1, w2, b2, w3, b3)
    if _lib.dispatch_device(points2, idx, points1, *weights) == "cpu":
        return fusion_pair_plain(points2, idx, points1, *weights)
    _lib.refuse_grad("fusion_pair", points2, points1, *weights)
    G, N, N2, K2 = _check_points(points2, idx, points1, "fusion_pair")
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
